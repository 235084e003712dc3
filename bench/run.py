"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for (else it exits 2 and prints no result). The cell's
driver sets up (weights and batches from the seed, the first rounds),
measures for `--seconds`, and hands back its state's readings; with the
program's state freed, the plain reference then follows the set-up rounds
and `bench.check` holds the two to the cell's limits. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checked`, each number compared beside its limit (also the last lines of
standard error, after every reading of the check). A process that holds a module of the JAX stack once the
window has closed exits 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from bench import check, harness  # noqa: E402


def run_cell(cell: harness.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float = T_START) -> tuple[dict, dict]:
    """One run of `cell` on `device`: (the result line as a dict, every
    reading of the check, the compared ones and the rest)."""
    out = cell.driver.run(cell, seed, seconds, traced, device, t_start)
    program = out.pop("program")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = check.readings(
        program, cell.driver.reference_rounds(cell, seed, device))
    readings["reference_s"] = time.perf_counter() - t0
    readings["setup_phases"] = out["setup_phases"]
    readings["kernels_built"] = out["kernels_built"]
    readings["round_walls"] = out["round_walls"]
    ok, checked = check.verdict(readings, cell.limits)
    correct = ok and out["failed"] == 0 and bool(out["round_walls"])
    metrics = {}
    if traced:
        obs = cell.driver.observations(cell, out)
        for spec in cell.per_layer:
            v = harness.reader(spec["name"]).read(obs)
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    else:
        metrics = {spec["name"]: {"value": out["end_to_end"][spec["name"]],
                                  "unit": spec["unit"]}
                   for spec in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        tr = out["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checked"] = checked
    return line, readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The program's work is on the card: one host thread for PyTorch's
    # own CPU pool keeps a run's load on a shared host to one core.
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, readings = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda:0"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the JAX stack loaded: {found}", file=sys.stderr)
        return 3
    print("readings " + json.dumps(readings), file=sys.stderr)
    for name, c in line["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
