"""Mini reproduction of the paper's headline result (Figures 6-7), on the
card.

The PyTorch port's counterpart of `examples/constellation_sweep.py`:
runs FedAvg vs FedAvgSch vs FedBuff on the 50-satellite constellation
across a station ladder and prints the months->days scheduling speedup.
Timing only: the contact windows are computed on the card, the rounds
are planned on the host.

  PYTHONPATH=src python examples/torch/constellation_sweep.py \
      [--rounds N] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.core import ALGORITHMS
from repro_torch.orbits import WalkerStar, compute_access_windows, \
    station_subnetwork
from repro_torch.sim import ConstellationSim, SimConfig


def main(argv=None) -> dict:
    """Run the sweep and print its table; returns {(stations, alg):
    {"round_s", "total_s", "idle_s", "n_rounds"}} beside the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "computes the contact windows on the host)")
    args = ap.parse_args(argv)

    c = WalkerStar(clusters=5, sats_per_cluster=10)
    print(f"constellation: {c.n_sats} satellites "
          f"({c.clusters} clusters x {c.sats_per_cluster})")
    print(f"{'stations':>8} | {'alg':>14} | {'round (h)':>9} | "
          f"{'total (days)':>12} | {'idle/round (h)':>14}")
    base_days = {}
    out = {}
    device = None
    for g in (1, 3, 5, 13):
        st = station_subnetwork(g)
        aw = compute_access_windows(c, st, horizon_s=90 * 86400.0,
                                    device=args.device)
        for alg in ("fedavg", "fedavg_sched", "fedbuff"):
            cfg = SimConfig(max_rounds=args.rounds,
                            horizon_s=90 * 86400.0, train=False)
            sim = ConstellationSim(c, st, ALGORITHMS[alg], cfg=cfg,
                                   access=aw, device=args.device)
            device = sim.device
            res = sim.run()
            days = res.total_time_s / 86400
            if alg == "fedavg":
                base_days[g] = days
            sp = base_days[g] / max(days, 1e-9)
            print(f"{g:>8} | {alg:>14} | "
                  f"{res.mean_round_duration_s/3600:>9.2f} | "
                  f"{days:>12.2f} | {res.mean_idle_per_round_s/3600:>14.3f}"
                  + (f"   ({sp:.1f}x)" if alg != "fedavg" else ""))
            out[(g, alg)] = {"round_s": res.mean_round_duration_s,
                             "total_s": res.total_time_s,
                             "idle_s": res.mean_idle_per_round_s,
                             "n_rounds": res.n_rounds}
    return {"cells": out, "device": str(device)}


if __name__ == "__main__":
    main()
