"""Quickstart: space-ified federated learning in ~30 lines, on the card.

The PyTorch port's counterpart of `examples/quickstart.py`: builds a
10-satellite Walker-Star constellation over 3 IGS ground stations,
space-ifies FedAvg, and runs 15 real FL rounds (orbital timing + actual
gradient updates on synthetic-FEMNIST, each local step one `prox_sgd`
launch for the whole client stack, each aggregation one `fedagg`).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.core import FedAvgSat, spaceify
from repro_torch.data import synth_femnist
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.sim import ConstellationSim, SimConfig


def main(argv=None, *, sampler=None) -> dict:
    """Run the quickstart and print its lines; returns the run's numbers.
    `sampler` is `ConstellationSim`'s random-source seam (tests replay
    the reference's draws through it); the command line never sets it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    constellation = WalkerStar(clusters=2, sats_per_cluster=5)
    stations = station_subnetwork(3)
    algorithm = spaceify(FedAvgSat(), schedule=True)   # + FLSchedule

    data = synth_femnist(constellation.n_sats, seed=0)
    sim = ConstellationSim(
        constellation, stations, algorithm, data=data,
        cfg=SimConfig(max_rounds=15, horizon_s=20 * 86400.0, eval_every=5),
        device=args.device, sampler=sampler,
    )
    result = sim.run()

    print(f"algorithm : {result.algorithm}")
    print(f"satellites: {result.n_sats}  stations: {result.n_stations}")
    for r, t, acc in result.accuracy_curve:
        print(f"  round {r:3d}  day {t/86400:5.1f}  accuracy {acc:.3f}")
    s = result.summary()
    print(f"mean round duration: {s['mean_round_duration_h']} h")
    print(f"total sim time     : {s['total_days']} days")
    return {"algorithm": result.algorithm, "rounds": result.rounds,
            "accuracy_curve": result.accuracy_curve, "summary": s,
            "device": str(sim.device)}


if __name__ == "__main__":
    main()
