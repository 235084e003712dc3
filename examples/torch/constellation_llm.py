"""End-to-end driver: federate a transformer across a satellite cluster,
on the card.

The PyTorch port's counterpart of `examples/constellation_llm.py`: the
paper's orchestration applied to an assigned LM architecture through the
port's simulation engine. `ConstellationSim` runs the same event loops,
selection protocols and contact-plan timing as the FEMNIST experiments,
with the LM supplied as a `Workload` (model + next-token loss +
federated token shards + derived cost model). Comms bytes and epoch
times are priced from the reduced architecture's parameter tree via
`HardwareModel.for_workload`. A client's local step is one forward and
backward of the whole client stack (`flash_attention` and its backward,
or `wkv6` for rwkv6) and one `prox_sgd` launch; a round aggregates with
one `fedagg` launch. `--execution mesh` runs the round as a collective
over `torch.distributed` (a one-rank group unless one is initialised).

  PYTHONPATH=src python examples/torch/constellation_llm.py \
      --arch gemma-2b --rounds 6 --alg fedprox [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.core import ALGORITHMS, lm_workload
from repro_torch.core.timing import HardwareModel
from repro_torch.orbits import WalkerStar, compute_access_windows, \
    station_subnetwork
from repro_torch.sim import ConstellationSim, SimConfig


def main(argv=None, *, sampler=None) -> dict:
    """Federate the LM and print its lines; returns the run's numbers.
    `sampler` is `ConstellationSim`'s random-source seam (tests replay
    the reference's draws through it); the command line never sets it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=lm_arch_ids())
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sats", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-steps", type=int, default=16)
    ap.add_argument("--alg", default="fedavg_sched",
                    choices=sorted(ALGORITHMS))
    ap.add_argument("--execution", default=None, choices=("host", "mesh"),
                    help="client-update execution: the client stack on one "
                         "device, or the round as a collective")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    wl = lm_workload(get_config(args.arch).reduced(), seq_len=args.seq,
                     samples_per_client=4 * args.batch)
    hw = HardwareModel.for_workload(wl)
    print(f"federating {wl.name}: {wl.n_params/1e6:.2f}M params "
          f"({wl.model_bytes/1e6:.1f} MB on the wire, "
          f"{hw.tx_time_s:.2f}s per transfer) across {args.sats} satellites")

    # Orbital side: one cluster of `sats` satellites, 3 ground stations.
    c = WalkerStar(clusters=1, sats_per_cluster=args.sats)
    horizon_s = 30 * 86400.0
    aw = compute_access_windows(c, station_subnetwork(3),
                                horizon_s=horizon_s, device=args.device)
    cfg = SimConfig(max_rounds=args.rounds, horizon_s=horizon_s,
                    batch_size=args.batch, lr=args.lr, eval_every=1,
                    max_steps=args.max_steps)
    sim = ConstellationSim(c, station_subnetwork(3), ALGORITHMS[args.alg],
                           workload=wl, hw=hw, cfg=cfg, access=aw,
                           execution=args.execution, device=args.device,
                           sampler=sampler)
    res = sim.run()

    print(f"execution mode: {res.execution}")
    for rec in res.rounds:
        acc = f"{rec.accuracy:.4f}" if rec.accuracy is not None else "  -   "
        print(f"round {rec.idx}: day {rec.t_end/86400:5.2f}  "
              f"token-acc {acc}  participants {rec.participants}  "
              f"comms {rec.total_comms_bytes/1e6:.1f} MB")
    print(f"{res.n_rounds} rounds in {res.total_time_s/86400:.1f} simulated "
          f"days; best token accuracy {res.max_accuracy:.4f}")
    return {"workload": wl.name, "n_params": wl.n_params,
            "model_bytes": wl.model_bytes, "tx_time_s": hw.tx_time_s,
            "execution": res.execution, "rounds": res.rounds,
            "accuracy_curve": res.accuracy_curve,
            "total_time_s": res.total_time_s,
            "max_accuracy": res.max_accuracy, "device": str(sim.device)}


if __name__ == "__main__":
    main()
