"""The readings that a cell's correctness limits are set from, at the
cell's own size: the program on many seeds, the control (the plain
reference in the program's place with its matrix products in float8
e4m3, the precision below the configuration's bfloat16) and the faults
planted in the program's round, each against the float32 reference.

    python3 -m bench.control --workload <cell> [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--first-seed <n>]
        [--leaves] [--out <file.jsonl>]

One JSON line per reading on standard output (and in --out). Each line
has the run's kind ("program", "control" or a fault's name), its seed,
and `bench.check.readings`; with --leaves also each leaf's change norms
on both sides and the reference's moved counts (`leaves`). The faults:

  unchanged       the round computes, then returns its input weights
  half_batch      the round trains on half the batch's rows (half the
                  tokens where there is one row), the mean over those
  answer_altered  the round's answer altered where it is produced: the
                  weights it returns carry twice its update
  full_attention_dq  (configurations with full-attention layers) the
                  attention backward returns half of dq in the layers
                  without a window: a kernel fault in a few layers

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from bench import check, harness

FAULTS = ("unchanged", "half_batch", "answer_altered")
KERNEL_FAULTS = ("full_attention_dq",)


def has_full_attention(cell) -> bool:
    return any(s.get("full_attention")
               for s in cell.config["model"]["segments"])


@contextlib.contextmanager
def kernel_fault(fault: str):
    """The program's attention backward with `fault` planted, inside."""
    harness.program_path()
    from repro_torch.kernels import ops
    fn = ops._FlashAttention
    backward = fn.backward

    def half_dq(ctx, do):
        dq, *rest = backward(ctx, do)
        return (dq * 0.5 if ctx.masks[1] is None else dq, *rest)
    fn.backward = staticmethod({"full_attention_dq": half_dq}[fault])
    try:
        yield
    finally:
        fn.backward = staticmethod(backward)


def planted(fault: str, call):
    """A replacement for the driver's `Round.__call__` with `fault`."""
    def unchanged(self, params, tokens):
        call(self, params, tokens)
        return params

    def half_batch(self, params, tokens):
        rows, seq = tokens.shape
        half = tokens[:rows // 2] if rows > 1 else tokens[:, :seq // 2]
        return call(self, params, half)

    def answer_altered(self, params, tokens):
        out = call(self, params, tokens)
        return harness.tree_map(lambda o, p: p + 2 * (o - p), out, params)
    return {"unchanged": unchanged, "half_batch": half_batch,
            "answer_altered": answer_altered}[fault]


def program_record(cell, seed, device, fault=None) -> dict:
    driver = cell.driver
    call = driver.Round.__call__
    if fault in FAULTS:
        driver.Round.__call__ = planted(fault, call)
    try:
        with (kernel_fault(fault) if fault in KERNEL_FAULTS
              else contextlib.nullcontext()):
            out = driver.run(cell, seed, 0.0, False, device,
                             time.perf_counter())
    finally:
        driver.Round.__call__ = call
    program = out["program"]
    del out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return program


def as_program(ref: dict) -> dict:
    """A reference record in the program's place."""
    return {"losses": ref["losses"],
            "change_norms": [ref["change_norms"][0], ref["change_norms"][-1]]}


def leaf_record(prog: dict, ref: dict) -> dict:
    """Each leaf's change norms on both sides, first and last round, and
    the reference's moved counts and first gradient norms."""
    return {"prog": prog["change_norms"],
            "ref": [ref["change_norms"][0], ref["change_norms"][-1]],
            "moved": [ref["moved"][0], ref["moved"][-1]],
            "grad": ref["grad_norms"]}


def readings_of(cell, device, seeds, control_seeds, fault_seeds,
                leaves=False):
    faults = FAULTS + (KERNEL_FAULTS if has_full_attention(cell) else ())

    def rec(kind, seed, prog, ref, **extra):
        out = {"kind": kind, "seed": seed, **extra,
               **check.readings(prog, ref)}
        if leaves:
            out["leaves"] = leaf_record(prog, ref)
        return out
    for i, seed in enumerate(seeds):
        program = program_record(cell, seed, device)
        t0 = time.perf_counter()
        ref = cell.driver.reference_rounds(cell, seed, device)
        ref_s = time.perf_counter() - t0
        if leaves and i == 0:
            yield {"kind": "paths", "paths": ref["paths"]}
        yield rec("program", seed, program, ref, reference_s=ref_s)
        if i < control_seeds:
            ctl = cell.driver.reference_rounds(cell, seed, device,
                                               "float8_e4m3")
            yield rec("control", seed, as_program(ctl), ref)
        if i < fault_seeds:
            for fault in faults:
                yield rec(fault, seed,
                          program_record(cell, seed, device, fault), ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    sink = open(args.out, "a") if args.out else None
    try:
        for rec in readings_of(cell, torch.device("cuda:0"), seeds,
                               args.control_seeds, args.fault_seeds,
                               args.leaves):
            line = json.dumps({"workload": cell.name, **rec})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
