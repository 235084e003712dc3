#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (`src/repro_torch`, never `jax` or `repro`) on the card:

  card       the card's name and power limit (nvidia-smi), torch / CUDA /
             nvcc versions, the kernels' build time (from the sources in
             this checkout), ptxas's registers and spills per kernel and,
             from `cuobjdump -sass`, its tensor-core (HGMMA/HMMA) and
             asynchronous-copy (UTMALDG/LDGSTS) instructions; fails if a
             bf16 flash_attention kernel has no tensor-core instruction;
  kernels    every CUDA kernel of the main path against its plain PyTorch
             version on the same inputs, in f32 (rtol = atol = 2e-5) and
             bf16 (2e-2), the tolerances of tests/test_kernels.py, with
             device times (CUDA events, median over 100 launches queued
             behind a device sleep so host enqueue time is not counted),
             the byte/flop bound, and a one-call PyTorch yardstick where
             one computes the same function; the floor of an empty launch
             timed the same way (`floor_ms`) and, for the simulator's
             kernels, the time with the L2 evicted before each launch
             (`ms_cold`), the mean time of a launch among 100 run back
             to back with no event between them (`ms_back_to_back`, and
             `floor_back_to_back_ms` for the empty launch) and the host
             time of one wrapper call (`host_us`);
  main_path  ConstellationSim.run() for all 8 Table-1 algorithms on the
             paper's largest cell (100 satellites, 13 stations), with the
             kernels' launch counters zeroed just before and read just
             after;
  where_time_goes  fedprox for 5 rounds on the same cell: host wall
             clock, per-span walls (repro_torch.obs) and, from
             torch.profiler, the device's busy time, idle share and
             kernel time by name;
  cpu_vs_card  fedprox on a small cell on the card and on the CPU with
             the same access windows, init params and minibatch draws:
             RoundRecords identical, final params within 1e-4.
  comms_path ConstellationSim.run() on the main-path cell for the ISL
             algorithms (fedavg_intracc_isl, fedprox_intracc_isl; ISL
             windows computed on the card), the connectivity-aware ones
             (fedspace, ground_assisted, fedprox_sparse), fedprox with each
             lossy uplink codec (quant_int8, quant_fp8, topk_sparse) and
             fedprox_intracc_isl priced by a LinkBudget; launch counters
             zeroed before and read after each run; each run needs both
             kernels launched, finite params, >= 10 rounds, and each ISL
             run at least one relayed return;
  path_shapes  prox_sgd and fedagg against their plain versions (same
             tolerances) at every distinct shape the main path and the
             comms path launched them with (recorded while those ran:
             partial-visit and buffered flushes, sparse rounds);
  comms_scale the 1,024-satellite plan of benchmarks/bench_scale.py
             (Walker-Star 32 x 32, cross-plane grid with 2 seam
             candidates, 13 stations, 1 day): access and ISL windows on
             the card, the contact plan with its geometry cache, its
             LinkBudget re-rating, and every satellite routed at t = 0
             (3 hops) under both pricings, with each stage's wall; the
             card's ISL grid against the CPU's, where every differing
             sample must be a threshold tie;
  comms_cpu_vs_card  fedprox_intracc_isl and fedprox with the int8 codec
             on a dense 10-satellite plane on the card and on the CPU
             with the same windows, init params, minibatch draws and
             codec uniforms: RoundRecords identical, ISL params within
             1e-4, int8 params within the bounds of
             tests/test_torch_engine.py's codec parity test.
  lm_kernels flash_attention and wkv6 against their plain versions at
             hymba-1.5b's serving shapes (wkv6 also in the SSD heads'
             broadcast layout) and in every mask variant on both flash
             kernels (flash 3e-5 in f32; in bf16 rtol 8e-3 + atol 1e-3,
             about one bf16 rounding step, since both sides round one
             f32 result; wkv6 2e-4), with device times, bounds and, for
             flash, scaled_dot_product_attention as the yardstick;
  serve      full-width hymba-1.5b (bf16, random weights from a seed):
             one batch of `serve.serve_batch` plain (wall) and under
             torch.profiler (with every launch of the port's kernels by
             kernel), then `repro_torch.launch.serve.main` with
             8 requests, batch 4, 2048-token prompts (past the 1024
             window: the ring cache rolls), 32 new tokens, launch
             counters zeroed just before and read just after;
  serve_cpu_vs_card  reduced hymba-1.5b and gemma-2b (f32) from the same
             weights on the card and on the CPU, 160-token prompts:
             identical greedy tokens, logits within 1e-4.

Each phase prints one JSON line; any failure exits non-zero before the
last line, which is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.comms import (  # noqa: E402
    ConstantRate,
    LinkBudget,
    build_contact_plan,
    compute_isl_windows,
)
from repro_torch.comms import isl  # noqa: E402
from repro_torch.comms.routing import batch_earliest_arrival  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ALGORITHMS,
    TABLE1_NAMES,
    FedProxSat,
    spaceify,
)
from repro_torch.core.timing import HardwareModel  # noqa: E402
from repro_torch.data import synth_femnist  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.femnist_mlp import femnist_mlp_init  # noqa: E402
from repro_torch.models.lm.params import (  # noqa: E402
    lm_params_from_jax,
    lm_params_to_numpy,
)
from repro_torch.models.lm.transformer import init_params  # noqa: E402
from repro_torch.orbits import (  # noqa: E402
    WalkerStar,
    compute_access_windows,
    station_subnetwork,
)
from repro_torch.params import params_to_numpy  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    ConstellationSim,
    SimConfig,
    TorchSampler,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the tensor
# cores, and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TIMED_LAUNCHES = 100
SLEEP_CYCLES = 100_000_000           # ~50 ms of device sleep at ~2 GHz
COLD_LAUNCHES = 50
FLUSH_BYTES = 256 << 20              # written before each cold launch: > L2
HOST_CALLS = 1000
P_MLP = 46_639                       # femnist_mlp parameters


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ card
def phase_card() -> dict:
    line = smi_line()
    print(line, flush=True)
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, timeout=60,
                                  check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    # ptxas's registers and spills, and from the machine code the count of
    # tensor-core (HGMMA/HMMA) and asynchronous-copy (UTMALDG/LDGSTS)
    # instructions, per kernel.
    sass = {r["kernel"]: r for r in build.sass_counts()}
    resources = [dict(row, **{k: v for k, v in sass.get(row["kernel"],
                                                        {}).items()
                              if k != "kernel"})
                 for row in build.resource_usage()]
    info = dict(nvidia_smi=line, name=torch.cuda.get_device_name(0),
                torch=torch.__version__, cuda=torch.version.cuda,
                nvcc=nvcc_version, python=sys.version.split()[0],
                kernel_build_s=build_s, kernel_resources=resources)
    emit("card", **info)
    bf16_flash = [r for r in resources
                  if "flash_bf16_kernel" in r["kernel"]]
    require(bool(bf16_flash) and all(r.get("tensor_core_ops", 0) > 0
                                     for r in bf16_flash),
            "a bf16 flash_attention kernel has no tensor-core instruction: "
            f"{bf16_flash}")
    return info


# --------------------------------------------------------------- kernels
def device_ms(fn) -> float:
    """Median device time of one call of `fn`, from CUDA events around
    each of TIMED_LAUNCHES calls enqueued while the device sleeps."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_LAUNCHES + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    events[0].record()
    for i in range(TIMED_LAUNCHES):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(TIMED_LAUNCHES))


def device_ms_back_to_back(fn) -> float:
    """Mean device time of one call of `fn` over TIMED_LAUNCHES calls run
    back to back between one pair of CUDA events (queued behind a device
    sleep), as the main path launches them: no event between calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(TIMED_LAUNCHES):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_LAUNCHES


def device_ms_cold(fn, flush: torch.Tensor) -> float:
    """Median device time of one call of `fn` with the L2 evicted first:
    `flush` (FLUSH_BYTES) is written and then read before each of
    COLD_LAUNCHES calls (read, so that the lines the call evicts are
    clean and their write-back is not counted against it), and one pair
    of CUDA events around each call leaves the flush untimed. The calls
    queue behind a device sleep, as in `device_ms`."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(COLD_LAUNCHES)]
    total = torch.empty((), device=flush.device)
    torch.cuda._sleep(SLEEP_CYCLES)
    for i, (start, end) in enumerate(pairs):
        flush.fill_(float(i))
        torch.sum(flush, dim=0, out=total)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn) -> float:
    """Median host microseconds of one call of `fn` over HOST_CALLS calls,
    started on an idle device (each call only enqueues its launch)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def _max_err(got, want, rtol: float, atol: float | None = None) -> float:
    """Max |got - want|; fails unless every element is within
    atol + rtol * |want| (atol = rtol unless given)."""
    atol = rtol if atol is None else atol
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    require(ok, f"kernel disagrees with its plain version: max abs err "
                f"{float(err.max())} > atol {atol} + rtol {rtol} * |want|")
    return float(err.max())


def check_fedagg(dev, K: int, P: int, dtype: str, delta: bool,
                 flush: torch.Tensor | None) -> dict:
    """The kernel against its plain version, then timed; with no `flush`
    buffer only the comparison is made."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(K * P)
    x = torch.randn((K, P), generator=g, device=dev).to(dt)
    w = torch.rand((K,), generator=g, device=dev)
    base = torch.randn((P,), generator=g, device=dev).to(dt) if delta \
        else None
    scale = 0.5 if delta else 1.0
    got = ops.fedagg_op(x, w, base, scale)
    want = ref.fedagg_ref(x, w, base, scale)
    torch.cuda.synchronize()
    err = _max_err(got, want, TOL[dtype])
    if flush is None:
        return dict(name="fedagg", form="delta" if delta else "plain", K=K,
                    P=P, dtype=dtype, max_abs_err=err, tol=TOL[dtype])
    es = x.element_size()
    n_bytes = K * P * es + K * 4 + P * es + (P * es if delta else 0)
    n_flops = 3 * K * P + 2 * P if delta else 2 * K * P
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    wl = w.to(dt)
    kernel = lambda: ops.fedagg_op(x, w, base, scale)  # noqa: E731
    return dict(
        name="fedagg", form="delta" if delta else "plain", K=K, P=P,
        dtype=dtype, max_abs_err=err, tol=TOL[dtype],
        ms=device_ms(kernel), ms_cold=device_ms_cold(kernel, flush),
        ms_back_to_back=device_ms_back_to_back(kernel),
        host_us=host_us(kernel),
        plain_ms=device_ms(lambda: ref.fedagg_ref(x, w, base, scale)),
        # One PyTorch call computing the plain form (a yardstick only).
        library_ms=(None if delta else
                    device_ms(lambda: torch.mv(x.t(), wl))),
        bound_ms=b_ms, bound_by=b_by)


def check_prox_sgd(dev, C: int, P: int, dtype: str, mu: float,
                   shared_anchor: bool, flush: torch.Tensor | None,
                   all_live: bool = False) -> dict:
    """Partly masked (3 of every 10 clients past their step budget), or
    with `all_live` every client live. Checked against the plain version,
    then timed; with no `flush` buffer only the comparison is made."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(C + P)
    w = torch.randn((C, P), generator=g, device=dev).to(dt)
    grad = torch.randn((C, P), generator=g, device=dev).to(dt)
    anchor = torch.randn((P,) if shared_anchor else (C, P), generator=g,
                         device=dev).to(dt)
    steps = torch.tensor([2 if c % 10 >= 7 and not all_live else 8
                          for c in range(C)], dtype=torch.int32, device=dev)
    step, lr = 3, 0.05
    got, want = w.clone(), w.clone()
    ops.prox_sgd_op(got, grad, anchor, steps, step, lr, mu)
    ref.prox_sgd_masked_ref_(want, grad, anchor, steps, step, lr, mu)
    torch.cuda.synchronize()
    err = _max_err(got, want, TOL[dtype])
    masked = steps <= step
    require(bool(torch.equal(got[masked], w[masked])),
            "prox_sgd wrote a masked row")
    live = int((~masked).sum())
    if flush is None:
        return dict(name="prox_sgd", C=C, P=P, dtype=dtype, mu=mu,
                    anchor="shared" if shared_anchor else "per_client",
                    live=live, max_abs_err=err, tol=TOL[dtype])
    es = w.element_size()
    n_bytes = 3 * live * P * es + (P if shared_anchor else live * P) * es \
        + C * 4
    b_ms, b_by = bound_ms(n_bytes, 5 * live * P)
    wk, wp, wl = w.clone(), w.clone(), w.clone()
    kernel = lambda: ops.prox_sgd_op(  # noqa: E731
        wk, grad, anchor, steps, step, lr, mu)
    return dict(
        name="prox_sgd", C=C, P=P, dtype=dtype, mu=mu,
        anchor="shared" if shared_anchor else "per_client", live=live,
        max_abs_err=err, tol=TOL[dtype],
        ms=device_ms(kernel), ms_cold=device_ms_cold(kernel, flush),
        ms_back_to_back=device_ms_back_to_back(kernel),
        host_us=host_us(kernel),
        plain_ms=device_ms(lambda: ref.prox_sgd_masked_ref_(
            wp, grad, anchor, steps, step, lr, mu)),
        # With every client live and mu = 0 the step is w - lr * g: one
        # PyTorch call computes it there (a yardstick only).
        library_ms=(device_ms(lambda: wl.add_(grad, alpha=-lr))
                    if live == C and mu == 0.0 else None),
        bound_ms=b_ms, bound_by=b_by)


def phase_kernels(dev) -> list[dict]:
    """The simulator's kernels' rows; the phase's line also carries the
    floor of an empty launch (`torch.cuda._sleep(0)`) timed as the kernels
    are (`floor_ms`, and back to back: `floor_back_to_back_ms`)."""
    flush = torch.empty((FLUSH_BYTES // 4,), device=dev)
    rows = []
    for dtype in ("float32", "bfloat16"):
        for K, P in ((10, P_MLP), (100, P_MLP), (7, 12345)):
            for delta in (False, True):
                rows.append(check_fedagg(dev, K, P, dtype, delta, flush))
        for C in (10, 100):
            for mu in (0.0, 0.1):
                for shared in (True, False):
                    rows.append(check_prox_sgd(dev, C, P_MLP, dtype,
                                               mu, shared, flush))
            rows.append(check_prox_sgd(dev, C, P_MLP, dtype, 0.0, True,
                                       flush, all_live=True))
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor = device_ms(empty)
    del flush
    emit("kernels", floor_ms=floor,
         floor_back_to_back_ms=device_ms_back_to_back(empty), rows=rows)
    return rows


class LaunchShapes:
    """Records the distinct shapes of the simulator kernels' launches
    while it is entered, by wrapping the launchers that `ops`' counted
    wrappers call (the launch counts are untouched), so that
    `phase_path_shapes` can hold the kernels to their plain versions at
    exactly the shapes a path gave them."""

    def __init__(self):
        self.fedagg: set[tuple] = set()
        self.prox_sgd: set[tuple] = set()

    def __enter__(self) -> "LaunchShapes":
        self._launchers = fedagg, prox_sgd = ops.fedagg, ops.prox_sgd

        def record_fedagg(x, w, base, scale):
            self.fedagg.add((x.shape[0], x.shape[1],
                             str(x.dtype).removeprefix("torch."),
                             base is not None))
            return fedagg(x, w, base, scale)

        def record_prox_sgd(w, g, w0, steps, step, lr, mu):
            self.prox_sgd.add((w.shape[0], w.shape[1],
                               str(w.dtype).removeprefix("torch."),
                               float(mu), w0.dim() == 1))
            return prox_sgd(w, g, w0, steps, step, lr, mu)

        ops.fedagg, ops.prox_sgd = record_fedagg, record_prox_sgd
        return self

    def __exit__(self, *exc) -> None:
        ops.fedagg, ops.prox_sgd = self._launchers


def phase_path_shapes(dev, shapes: dict[str, LaunchShapes]) -> dict:
    """`fedagg` and `prox_sgd` against their plain versions at every
    distinct shape the main path and the comms path launched them with
    (partial-visit and buffered flushes, sparse rounds), on fresh random
    inputs: no timing, the `kernels` phase times the main-path shapes."""
    out = {}
    for path, rec in shapes.items():
        require(rec.fedagg and rec.prox_sgd,
                f"{path}: no kernel launch was recorded")
        rows = [check_fedagg(dev, K, P, dtype, delta, None)
                for K, P, dtype, delta in sorted(rec.fedagg)]
        rows += [check_prox_sgd(dev, C, P, dtype, mu, shared, None)
                 for C, P, dtype, mu, shared in sorted(rec.prox_sgd)]
        out[path] = dict(
            fedagg=[f"{r['form']} K={r['K']} P={r['P']} {r['dtype']}"
                    for r in rows if r["name"] == "fedagg"],
            prox_sgd=[f"C={r['C']} P={r['P']} {r['dtype']} mu={r['mu']} "
                      f"{r['anchor']}" for r in rows
                      if r["name"] == "prox_sgd"],
            max_abs_err=max(r["max_abs_err"] for r in rows))
    emit("path_shapes", **out)
    return out


# ------------------------------------------------------------- main path
MAIN_CELL = "c10s10/g13"
MAIN_HORIZON_S = 2 * 86400.0


def main_path_setup(dev) -> dict:
    """The paper's largest cell (100 satellites, 13 stations): data,
    constellation, stations and access windows (computed on the card)."""
    t0 = time.perf_counter()
    data = synth_femnist(100, seed=0)
    data_s = time.perf_counter() - t0
    cst, st = WalkerStar(10, 10), station_subnetwork(13)
    t0 = time.perf_counter()
    aw = compute_access_windows(cst, st, horizon_s=MAIN_HORIZON_S,
                                device=dev)
    torch.cuda.synchronize()
    return dict(data=data, cst=cst, st=st, aw=aw, data_s=data_s,
                access_windows_s=time.perf_counter() - t0)


def phase_main_path(dev, setup: dict) -> dict:
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=20, horizon_s=MAIN_HORIZON_S, eval_every=5)
    per_alg = []
    ops.reset_launches()          # the main path's counts start here
    for name in TABLE1_NAMES:
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        sim = ConstellationSim(cst, st, ALGORITHMS[name],
                               data=data, cfg=cfg, access=aw, device=dev)
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        accs = [a for _, _, a in res.accuracy_curve]
        per_alg.append(dict(algorithm=name, rounds=res.n_rounds,
                            wall_s=wall, accuracy=accs,
                            launches=launches))
        require(res.n_rounds >= 10,
                f"{name}: {res.n_rounds} rounds (< 10) in 2 days")
        require(launches["prox_sgd"] > 0 and launches["fedagg"] > 0,
                f"{name}: a kernel was never launched: {launches}")
        require(sim.device.type == "cuda" and res.final_params is not None,
                f"{name}: final params did not come from the card")
        leaves = [v for layer in res.final_params.values()
                  for v in layer.values()]
        require(sum(v.size for v in leaves) == P_MLP
                and all(bool(np.isfinite(v).all())
                        for v in leaves), f"{name}: bad final params")
        require(bool(accs) and all(math.isfinite(a) for a in accs),
                f"{name}: accuracy not finite: {accs}")
    totals = dict(ops.LAUNCHES)
    out = dict(cell=MAIN_CELL, horizon_days=MAIN_HORIZON_S / 86400.0,
               data_s=setup["data_s"],
               access_windows_s=setup["access_windows_s"],
               algorithms=per_alg, launches=totals)
    emit("main_path", **out)
    return out


# ------------------------------------------------------ where time goes
PROFILE_ALGORITHM = "fedprox"
PROFILE_ROUNDS = 5


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_where_time_goes(dev, setup: dict) -> dict:
    """One Table-1 algorithm for a few rounds on the main-path cell, run
    three times: plain (host wall clock), traced with `repro_torch.obs`
    (per-span walls; each traced span ends in a device sync) and under
    `torch.profiler` (device busy time and kernel time by name). The
    device's idle share is 1 - busy / the plain run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=PROFILE_ROUNDS, horizon_s=MAIN_HORIZON_S,
                    eval_every=5)

    def run() -> float:
        t0 = time.perf_counter()
        ConstellationSim(cst, st, ALGORITHMS[PROFILE_ALGORITHM], data=data,
                         cfg=cfg, access=aw, device=dev).run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = run()
    with obs.tracing():
        traced_wall = run()
        spans = obs.metrics_summary()["spans"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall = run()
    out = dict(
        algorithm=PROFILE_ALGORITHM, cell=MAIN_CELL, rounds=PROFILE_ROUNDS,
        wall_s=wall, traced_wall_s=traced_wall,
        profiled_wall_s=profiled_wall,
        spans={k: v for k, v in spans.items() if k.startswith("sim.")},
        **_device_time(prof, wall))
    emit("where_time_goes", **out)
    return out


PORT_KERNEL_NAMES = ("prox_sgd_kernel", "fedagg_kernel", "flash_f32_kernel",
                     "flash_bf16_kernel", "wkv6_")


def _device_time(prof, wall_s: float) -> dict:
    """Device events of a `torch.profiler` run: their count, the busy
    time (union of their intervals), the idle share against `wall_s` (a
    plain run's wall), time by kernel name (top 12) and the launches,
    time and mean time a launch of each of the port's own kernels."""
    from torch.autograd import DeviceType

    device_events = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in device_events:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us()
    busy_s = _busy_us([(e.time_range.start, e.time_range.end)
                       for e in device_events]) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(
        device_events=len(device_events),
        device_busy_s=busy_s if device_events else None,
        device_idle_share=(1.0 - busy_s / wall_s) if device_events else None,
        device_time_by_name=[dict(name=k[:100], count=n, total_s=us / 1e6)
                             for k, (n, us) in top],
        # Every CUDA launch of the port's own kernels, by kernel.
        port_kernels=[dict(name=k[:100], count=n, total_s=us / 1e6,
                           mean_us=us / n)
                      for k, (n, us) in sorted(by_name.items())
                      if any(s in k for s in PORT_KERNEL_NAMES)])


# ----------------------------------------------------------- cpu vs card
class _OnDevice:
    """A sampler whose draws are made by `inner` (on the CPU) and moved
    to `device`, so the CPU and card runs train on the same minibatches."""

    def __init__(self, inner, device):
        self.inner, self.device = inner, device

    def init(self, workload):
        return self.inner.init(workload).to(self.device)

    def minibatches(self, n_valid, bound, batch_size):
        return self.inner.minibatches(n_valid, bound,
                                      batch_size).to(self.device)

    def codec_uniforms(self, n_clients, layout):
        return self.inner.codec_uniforms(n_clients, layout).to(self.device)


def phase_cpu_vs_card(dev) -> dict:
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    horizon = 4 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    data = synth_femnist(cst.n_sats, seed=0)
    init = params_to_numpy(femnist_mlp_init(
        torch.Generator().manual_seed(0), "cpu"))
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16)
    alg = ALGORITHMS["fedprox"]
    runs = {}
    for where, device, sampler in (
            ("cpu", "cpu", TorchSampler(0, "cpu")),
            ("card", dev, _OnDevice(TorchSampler(0, "cpu"), dev))):
        runs[where] = ConstellationSim(
            cst, st, alg, data=data, cfg=cfg, access=aw, device=device,
            sampler=sampler, init_params=init).run()
    fields = ("idx", "t_start", "t_end", "participants", "epochs",
              "idle_s", "compute_s", "comm_s", "relays", "staleness",
              "relay_hops", "comms_bytes")
    recs = {k: [[getattr(r, f) for f in fields] for r in v.rounds]
            for k, v in runs.items()}
    require(len(recs["card"]) == 3 and recs["card"] == recs["cpu"],
            "RoundRecords differ between the card and the CPU")
    gap = max(float(np.max(np.abs(runs["card"].final_params[l][m]
                                  - runs["cpu"].final_params[l][m])))
              for l in ("fc1", "fc2") for m in ("b", "w"))
    out = dict(algorithm="fedprox", cell="c2s2/g1", rounds=3,
               records_identical=True, final_params_max_abs_gap=gap,
               tol=1e-4,
               accuracy_card=[a for _, _, a in runs["card"].accuracy_curve],
               accuracy_cpu=[a for _, _, a in runs["cpu"].accuracy_curve])
    emit("cpu_vs_card", **out)
    require(gap <= 1e-4, f"final params differ by {gap} > 1e-4")
    return out


# ------------------------------------------------------------ comms path
COMMS_ROUNDS = 12
ISL_NAMES = ("fedavg_intracc_isl", "fedprox_intracc_isl")
CONNECTIVITY_NAMES = ("fedspace", "ground_assisted", "fedprox_sparse")
LOSSY_CODECS = ("quant_int8", "quant_fp8", "topk_sparse")


def _check_final_params(label: str, res) -> None:
    require(res.final_params is not None, f"{label}: no final params")
    leaves = [v for layer in res.final_params.values()
              for v in layer.values()]
    require(sum(v.size for v in leaves) == P_MLP
            and all(bool(np.isfinite(v).all()) for v in leaves),
            f"{label}: bad final params")


def phase_comms_path(dev, setup: dict) -> dict:
    """The ISL, connectivity-aware and codec algorithms on the main-path
    cell, each run traced (`repro_torch.obs`: the comms counters, and each
    span ends in a device sync) with the launch counters zeroed just
    before it and read just after."""
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=COMMS_ROUNDS, horizon_s=MAIN_HORIZON_S,
                    eval_every=5)
    runs = [(name, ALGORITHMS[name], {}) for name in ISL_NAMES
            + CONNECTIVITY_NAMES]
    runs += [(f"fedprox_{c}", spaceify(FedProxSat(), codec=c), {})
             for c in LOSSY_CODECS]
    runs.append(("fedprox_intracc_isl+LinkBudget",
                 ALGORITHMS["fedprox_intracc_isl"],
                 dict(link_model=LinkBudget())))
    out_runs = []
    totals = {"prox_sgd": 0, "fedagg": 0}
    for label, alg, kw in runs:
        ops.reset_launches()          # this run's counts start here
        t0 = time.perf_counter()
        with obs.tracing():
            sim = ConstellationSim(cst, st, alg, data=data, cfg=cfg,
                                   access=aw, device=dev, **kw)
            res = sim.run()
            torch.cuda.synchronize()
            counters = obs.metrics_summary()["counters"]
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for k in totals:
            totals[k] += launches[k]
        relays = sum(1 for r in res.rounds for x in r.relays if x >= 0)
        row = dict(
            run=label, algorithm=res.algorithm, rounds=res.n_rounds,
            wall_s=wall, launches=launches,
            accuracy=[a for _, _, a in res.accuracy_curve],
            relays=relays,
            relay_hops=sum(h for r in res.rounds for h in r.relay_hops),
            comms_bytes=sum(r.total_comms_bytes for r in res.rounds),
            wire_bytes_saved=sum(r.wire_bytes_saved for r in res.rounds),
            codec_error=counters.get("comms.codec_error"),
            encoded_bytes=counters.get("comms.encoded_bytes"),
            plan=None if sim.plan is None else dict(
                isl_edges=len(sim.plan.isl),
                isl_windows=sum(len(e) for e in sim.plan.isl.values())))
        out_runs.append(row)
        print(json.dumps({"phase": "comms_path_run", **row}), flush=True)
        require(res.n_rounds >= 10,
                f"{label}: {res.n_rounds} rounds (< 10) in 2 days")
        require(launches["prox_sgd"] > 0 and launches["fedagg"] > 0,
                f"{label}: a kernel was never launched: {launches}")
        require(sim.device.type == "cuda", f"{label}: not on the card")
        _check_final_params(label, res)
        require(all(math.isfinite(a) for a in row["accuracy"]),
                f"{label}: accuracy not finite")
        if alg.isl:
            require(relays >= 1, f"{label}: no relayed return")
        if alg.codec != "identity":
            require(row["wire_bytes_saved"] > 0
                    and row["codec_error"] is not None
                    and row["codec_error"] > 0,
                    f"{label}: the codec saved no bytes or changed nothing")
    out = dict(cell=MAIN_CELL, horizon_days=MAIN_HORIZON_S / 86400.0,
               max_rounds=COMMS_ROUNDS, runs=out_runs, launches=totals)
    emit("comms_path", **{k: v for k, v in out.items() if k != "runs"},
         walls_s={r["run"]: r["wall_s"] for r in out_runs})
    return out


SCALE_PLANES, SCALE_SATS = 32, 32   # 1,024 satellites (bench_scale.py)
SCALE_HORIZON_S = 86400.0
SCALE_MAX_HOPS = 3
# Threshold-tie band of the ISL distance tests (tests/test_torch_comms.py).
ISL_TIE_M = 50.0


def _route_stats(plan, n_sats: int, n_bytes: float) -> dict:
    t0 = time.perf_counter()
    routes = batch_earliest_arrival(plan, list(range(n_sats)), 0.0,
                                    n_bytes, max_hops=SCALE_MAX_HOPS)
    wall = time.perf_counter() - t0
    reached = [r for r in routes if r is not None]
    hops = np.array([r.isl_hops for r in reached])
    arrivals = np.array([r.arrival_s for r in reached])
    return dict(route_s=wall, reach_frac=len(reached) / n_sats,
                relay_frac=float((hops > 0).mean()) if reached else None,
                mean_hops=float(hops.mean()) if reached else None,
                mean_arrival_h=float(arrivals.mean()) / 3600
                if reached else None)


def phase_comms_scale(dev) -> dict:
    """`benchmarks/bench_scale.py`'s 1,024-satellite plan through the
    port: windows on the card, plan, re-rating and batch routing on the
    host (numpy), each stage's wall; then the card's ISL visibility grid
    against the CPU's, sample by sample."""
    cst, st = WalkerStar(SCALE_PLANES, SCALE_SATS), station_subnetwork(13)
    walls = {}
    t0 = time.perf_counter()
    aw = compute_access_windows(cst, st, horizon_s=SCALE_HORIZON_S,
                                device=dev)
    walls["access_windows"] = time.perf_counter() - t0
    topo = isl.ISLTopology.walker_grid(cst, cross_plane=True, seam_k=2)
    t0 = time.perf_counter()
    iw = compute_isl_windows(cst, topo, horizon_s=SCALE_HORIZON_S,
                             device=dev)
    walls["isl_windows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_contact_plan(aw, iw, ConstantRate(), constellation=cst,
                              stations=st, cache_geometry=True)
    walls["contact_plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_b = plan.rerate(LinkBudget())
    walls["rerate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.tables()
    plan_b.tables()
    walls["window_tables"] = time.perf_counter() - t0
    n_bytes = HardwareModel().model_bytes
    routes = {"const": _route_stats(plan, cst.n_sats, n_bytes),
              "budget": _route_stats(plan_b, cst.n_sats, n_bytes)}

    # The card's ISL grid against the CPU's over the whole day.
    el = cst.elements()
    ei = torch.tensor([i for i, _ in topo.edges])
    ej = torch.tensor([j for _, j in topo.edges])
    n_steps = int(np.ceil(SCALE_HORIZON_S / iw.dt_s)) + 1
    t = torch.as_tensor(np.arange(n_steps) * iw.dt_s, dtype=torch.float32)
    reach = isl.DEFAULT_ISL_MAX_RANGE_KM * 1e3
    t0 = time.perf_counter()
    card = isl.isl_visibility_grid(el, ei.to(dev), ej.to(dev), t.to(dev),
                                   reach).cpu()
    torch.cuda.synchronize()
    walls["isl_grid_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = isl.isl_visibility_grid(el, ei, ej, t, reach)
    walls["isl_grid_cpu"] = time.perf_counter() - t0
    min_r, rng = isl.isl_margins(el, ei, ej, t)
    diff = cpu != card
    tie = (((min_r - (isl.R_EARTH + isl.ATMOSPHERE_PAD_M)).abs()
            <= ISL_TIE_M) | ((rng - reach).abs() <= ISL_TIE_M))
    not_ties = int((diff & ~tie).sum())
    out = dict(
        sats=cst.n_sats, stations=len(st), horizon_days=1.0,
        isl_edges=topo.n_edges,
        isl_windows=sum(len(s) for s, _ in iw.per_edge),
        ground_windows=sum(len(s) for s, _ in aw.per_sat),
        plan_isl_edges=len(plan.isl), walls_s=walls, routes=routes,
        isl_grid_samples=int(diff.numel()),
        isl_grid_visible_share=float(cpu.float().mean()),
        isl_grid_differing_samples=int(diff.sum()),
        isl_grid_differing_not_ties=not_ties, tie_m=ISL_TIE_M)
    emit("comms_scale", **out)
    require(not_ties == 0, f"{not_ties} ISL samples differ between the "
            "card and the CPU away from a threshold tie")
    require(routes["const"]["reach_frac"] > 0.9
            and routes["const"]["relay_frac"] > 0,
            f"routing reached too little: {routes}")
    return out


def phase_comms_cpu_vs_card(dev) -> dict:
    """fedprox_intracc_isl and fedprox with the int8 codec on c1s10/g1
    over 2 days (a dense plane whose ISL ring relays), 4 clients a round,
    on the card and on the CPU: one set of access and ISL windows (one
    contact plan), init params, minibatch draws and codec uniforms."""
    cst, st = WalkerStar(1, 10), station_subnetwork(1)
    horizon = 2 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    iw = compute_isl_windows(cst, horizon_s=horizon, device="cpu")
    plan = build_contact_plan(aw, iw)
    data = synth_femnist(cst.n_sats, seed=0)
    init = params_to_numpy(femnist_mlp_init(
        torch.Generator().manual_seed(0), "cpu"))
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16, clients_per_round=4)
    fields = ("idx", "t_start", "t_end", "participants", "epochs",
              "idle_s", "compute_s", "comm_s", "relays", "staleness",
              "relay_hops", "comms_bytes", "wire_bytes_saved")
    out = {}
    for label, alg in (("fedprox_intracc_isl",
                        ALGORITHMS["fedprox_intracc_isl"]),
                       ("fedprox_quant_int8",
                        spaceify(FedProxSat(), codec="quant_int8"))):
        runs = {}
        for where, device, sampler in (
                ("cpu", "cpu", TorchSampler(0, "cpu")),
                ("card", dev, _OnDevice(TorchSampler(0, "cpu"), dev))):
            runs[where] = ConstellationSim(
                cst, st, alg, data=data, cfg=cfg, access=aw,
                contact_plan=plan if alg.isl else None, device=device,
                sampler=sampler, init_params=init).run()
        recs = {k: [[getattr(r, f) for f in fields] for r in v.rounds]
                for k, v in runs.items()}
        flat = {k: np.concatenate([v.final_params[l][m].reshape(-1)
                                   for l in ("fc1", "fc2")
                                   for m in ("b", "w")])
                for k, v in runs.items()}
        gap = np.abs(flat["card"] - flat["cpu"])
        accs = {k: [a for _, _, a in v.accuracy_curve]
                for k, v in runs.items()}
        row = dict(
            rounds=len(recs["card"]),
            records_identical=recs["card"] == recs["cpu"],
            relays=sum(1 for r in runs["card"].rounds
                       for x in r.relays if x >= 0),
            final_params_max_abs_gap=float(gap.max()),
            params_over_1e5=int((gap > 1e-5).sum()),
            relative_l2=float(np.linalg.norm(flat["card"] - flat["cpu"])
                              / np.linalg.norm(flat["cpu"])),
            accuracy_card=accs["card"], accuracy_cpu=accs["cpu"])
        out[label] = row
        require(row["rounds"] == 3 and row["records_identical"],
                f"{label}: RoundRecords differ between the card and the CPU")
        if alg.isl:
            require(row["relays"] >= 1, f"{label}: no relayed return")
            require(row["final_params_max_abs_gap"] <= 1e-4,
                    f"{label}: final params differ by "
                    f"{row['final_params_max_abs_gap']} > 1e-4")
        else:
            # tests/test_torch_engine.py::
            # test_quant_int8_training_within_codec_bounds
            require(row["params_over_1e5"] <= 100
                    and row["relative_l2"] <= 1e-4
                    and all(abs(a - b) <= 2 / 256 for a, b in
                            zip(accs["card"], accs["cpu"])),
                    f"{label}: card and CPU outside the codec bounds: {row}")
    emit("comms_cpu_vs_card", cell="c1s10/g1", **out)
    return out


# ------------------------------------------------------------ lm kernels
# (rtol, atol). In bf16 both sides round one f32 result, so they differ
# by at most one bf16 step: 2**-7 * |want| < 8e-3 * |want|.
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (8e-3, 1e-3)}
WKV6_TOL = 2e-4
# hymba-1.5b serving: batch 4, 2048-token prompts, 25 query heads on 5 KV
# heads of 64; its SSD heads: 50 heads, state 16, head dim 64.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS = 4, 2048, 32, 8


def _flash_pairs(S: int, causal: bool, window: int | None) -> int:
    """(q, k) pairs that the masks leave, over positions 0..S-1."""
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    hi = q + 1 if causal else np.full(S, S)
    return int((hi - lo).sum())


def check_flash(dev, case: str, B: int, H: int, KV: int, S: int, D: int,
                dtype: str, causal: bool = True, window: int | None = None,
                softcap: float | None = None) -> dict:
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(B * H * S + D)
    q = torch.randn((B, H, S, D), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, KV, S, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention_op(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _max_err(got, want, *FLASH_TOL[dtype])
    pairs = B * H * _flash_pairs(S, causal, window)
    n_bytes = (2 * B * H * S * D + 2 * B * KV * S * D) * q.element_size()
    b_ms, b_by = bound_ms(n_bytes, 4 * D * pairs,
                          BF16_FLOPS_PER_S if dtype == "bfloat16"
                          else F32_FLOPS_PER_S)
    # One PyTorch call computing the same function (a yardstick only).
    library = None
    if causal and softcap is None:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            library = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device=dev)
            lag = pos[:, None] - pos[None, :]
            mask = (lag >= 0) & (lag < window)
            library = lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    return dict(
        name="flash_attention", case=case, B=B, H=H, KV=KV, S=S, D=D,
        dtype=dtype, causal=causal, window=window, softcap=softcap,
        pairs=pairs, max_abs_err=err, rtol=FLASH_TOL[dtype][0],
        atol=FLASH_TOL[dtype][1],
        ms=device_ms(lambda: ops.flash_attention_op(q, k, v, **kw)),
        plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
        library_ms=None if library is None else device_ms(library),
        bound_ms=b_ms, bound_by=b_by)


def check_wkv6(dev, case: str, B: int, H: int, T: int, K: int, V: int,
               chunk: int = 64, strong_decay: bool = False,
               ssd_views: bool = False) -> dict:
    """With `ssd_views`, the inputs are laid out as the SSD heads pass them
    (models/lm/ssm.py): k broadcast over heads, logw over the state dim
    (stride 0), v a transposed (B, T, H, V) view."""
    g = torch.Generator(device=dev).manual_seed(B * H * T + K)
    r = torch.randn((B, H, T, K), generator=g, device=dev)
    if ssd_views:
        k = torch.randn((B, 1, T, K), generator=g, device=dev).expand(
            B, H, T, K)
        v = torch.randn((B, T, H, V), generator=g, device=dev).transpose(1, 2)
    else:
        k = torch.randn((B, H, T, K), generator=g, device=dev)
        v = torch.randn((B, H, T, V), generator=g, device=dev)
    if strong_decay:                     # near-total decay every step
        lw = torch.full((B, H, T, K), -5.0, device=dev)
        s0 = torch.zeros((B, H, K, V), device=dev)
    elif ssd_views:
        lw = -0.3 * torch.randn((B, H, T, 1), generator=g,
                                device=dev).abs().expand(B, H, T, K)
        s0 = torch.zeros((B, H, K, V), device=dev)
    else:
        lw = -0.3 * torch.randn((B, H, T, K), generator=g, device=dev).abs()
        s0 = torch.randn((B, H, K, V), generator=g, device=dev)
    args = (r, k, v, lw, s0)
    o, s_final = ops.wkv6_op(*args, chunk=chunk)
    want_o, want_s = ref.wkv6_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    err = max(_max_err(o, want_o, WKV6_TOL), _max_err(s_final, want_s,
                                                       WKV6_TOL))
    # Each input read once (a broadcast input's distinct elements), each
    # output written once.
    n_in = sum(x.untyped_storage().nbytes() for x in args)
    n_bytes = n_in + (B * H * T * V + B * H * K * V) * 4
    # The step-by-step recurrence: o = r.S (2KV), S = w S + k v^T (3KV).
    b_ms, b_by = bound_ms(n_bytes, 5 * B * H * T * K * V)
    return dict(
        name="wkv6", case=case, B=B, H=H, T=T, K=K, V=V, chunk=chunk,
        strong_decay=strong_decay, ssd_views=ssd_views, max_abs_err=err,
        tol=WKV6_TOL,
        ms=device_ms(lambda: ops.wkv6_op(*args, chunk=chunk)),
        plain_ms=device_ms(lambda: ref.wkv6_ref(*args, chunk=chunk)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_lm_kernels(dev) -> list[dict]:
    B, S = SERVE_BATCH, SERVE_PROMPT
    rows = []
    for dtype in ("bfloat16", "float32"):
        rows.append(check_flash(dev, "serve_swa", B, 25, 5, S, 64, dtype,
                                window=1024))
        rows.append(check_flash(dev, "serve_full", B, 25, 5, S, 64, dtype))
    # The mask cases of tests/test_kernels.py (its D = 32 GQA case at 64),
    # on both kernels.
    for dtype in ("float32", "bfloat16"):
        for b, h, kv, s, d, causal, window, softcap in (
                (1, 2, 2, 128, 64, True, None, None),
                (2, 4, 2, 128, 64, True, None, None),
                (1, 4, 1, 256, 64, True, 64, None),
                (1, 2, 2, 128, 64, False, None, None),
                (1, 2, 2, 128, 64, True, None, 30.0),
                (1, 2, 1, 64, 128, True, 16, None)):
            rows.append(check_flash(dev, "mask_sweep", b, h, kv, s, d, dtype,
                                    causal, window, softcap))
    rows.append(check_flash(dev, "bf16", 1, 2, 2, 128, 64, "bfloat16"))
    rows.append(check_flash(dev, "ragged_S", B, 25, 5, 1000, 64, "bfloat16",
                            window=256))
    rows.append(check_flash(dev, "mqa_d256", 1, 8, 1, S, 256, "bfloat16"))
    rows.append(check_flash(dev, "gqa_d128", 1, 32, 8, 1024, 128,
                            "bfloat16", window=512))
    rows.append(check_wkv6(dev, "serve", B, 50, S, 16, 64))
    rows.append(check_wkv6(dev, "serve_ssd_views", B, 50, S, 16, 64,
                           ssd_views=True))
    rows.append(check_wkv6(dev, "k64_v64", B, 32, S, 64, 64))
    rows.append(check_wkv6(dev, "ragged_T", 2, 50, 1000, 16, 64))
    rows.append(check_wkv6(dev, "strong_decay", 1, 1, 256, 32, 32,
                           chunk=128, strong_decay=True))
    emit("lm_kernels", rows=rows)
    return rows


# ----------------------------------------------------------------- serve
SERVE_ARCH = "hymba-1.5b"


def phase_serve(dev) -> dict:
    """Full-width hymba-1.5b: one batch of `serve.serve_batch` plain
    (wall) and under torch.profiler (device busy time and kernel time by
    name), after a warm-up batch on the same weights; then `serve.main`
    (traced, so the prefill span and every decode step end in a device
    sync), which draws its own weights as a user's run does."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve.serve_batch(cfg, params, prompts, SERVE_NEW)   # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve.serve_batch(cfg, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.serve_batch(cfg, params, prompts, SERVE_NEW)
        torch.cuda.synchronize()
    profiled = dict(wall_s=batch_wall, **_device_time(prof, batch_wall))
    profile_s = time.perf_counter() - t0
    del params, prof

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                 # the serve path's counts start here
    t0 = time.perf_counter()
    with obs.tracing():
        done, tokens, logits = serve.main([
            "--arch", SERVE_ARCH, "--full-config", "--device", "cuda",
            "--requests", str(SERVE_REQUESTS), "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--max-new", str(SERVE_NEW)])
        summary = obs.metrics_summary()
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_batches = SERVE_REQUESTS // SERVE_BATCH
    want = cfg.n_layers * n_batches
    require(launches["flash_attention"] == want
            and launches["wkv6"] == want,
            f"serve launched {launches}; expected {want} flash_attention "
            f"and {want} wkv6")
    require(tokens.shape == (SERVE_REQUESTS, SERVE_NEW + 1)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"serve tokens out of range or misshapen: {tuple(tokens.shape)}")
    require(logits.shape == (SERVE_REQUESTS, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "serve logits not finite")
    spans, counters = summary["spans"], summary["counters"]
    require(counters.get("launch.requests_served") == SERVE_REQUESTS
            and counters.get("launch.decode_tokens")
            == SERVE_REQUESTS * SERVE_NEW, f"serve counters: {counters}")
    serving_s = spans["launch.serve_batch"]["total_s"]
    out = dict(
        arch=SERVE_ARCH, dtype=cfg.dtype, requests=SERVE_REQUESTS,
        batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
        launches=launches, record=done, main_wall_s=main_wall,
        serving_wall_s=serving_s,
        tokens_per_s=SERVE_REQUESTS * SERVE_NEW / serving_s,
        prefill_ms_per_batch=spans["launch.prefill"]["total_s"]
        / spans["launch.prefill"]["count"] * 1e3,
        decode_ms_per_batch=spans["launch.decode"]["total_s"]
        / spans["launch.decode"]["count"] * 1e3,
        decode_p50_ms=done["decode_p50_ms"],
        decode_p99_ms=done["decode_p99_ms"],
        peak_device_memory_bytes=peak,
        setup_s=dict(init=init_s, warmup=warmup_s, profile=profile_s),
        profiled_batch=profiled)
    emit("serve", **out)
    return out


def phase_serve_cpu_vs_card(dev) -> dict:
    """Reduced hymba-1.5b and gemma-2b (f32) from the same weights through
    `serve.serve_batch` on the CPU and the card: prefill of a 160-token
    prompt (the reduced 128-token window rolls), then 8 greedy decode
    steps."""
    out = {}
    for arch in (SERVE_ARCH, "gemma-2b"):
        cfg = get_config(arch).reduced()
        cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
        prompts = torch.randint(0, cfg.vocab_size, (2, 160),
                                generator=torch.Generator().manual_seed(1))
        runs = {}
        for where, params in (("cpu", cpu_params), ("card", card_params)):
            toks, _, logits = serve.serve_batch(
                cfg, params, prompts.to(params["embed"].device), 8)
            runs[where] = (toks.cpu(), logits.cpu())
        same = bool(torch.equal(runs["card"][0], runs["cpu"][0]))
        gap = float((runs["card"][1] - runs["cpu"][1]).abs().max())
        out[arch] = dict(tokens_identical=same, logits_max_abs_gap=gap,
                         tol=1e-4)
        require(same, f"{arch}: greedy tokens differ between card and CPU")
        require(gap <= 1e-4, f"{arch}: logits differ by {gap} > 1e-4")
    emit("serve_cpu_vs_card", **out)
    return out


# ------------------------------------------------------------------ main
def _pick(rows: list[dict], **match) -> dict:
    for r in rows:
        if all(r.get(k) == v for k, v in match.items()):
            return r
    raise SmokeFailure(f"no kernel row matches {match}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    phases_s: dict[str, float] = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases_s[name] = time.perf_counter() - t0
        return out

    timed("card", phase_card)
    rows = timed("kernels", phase_kernels, dev)
    setup = timed("main_path_setup", main_path_setup, dev)
    shapes = {"main_path": LaunchShapes(), "comms_path": LaunchShapes()}
    with shapes["main_path"]:
        main_path = timed("main_path", phase_main_path, dev, setup)
    timed("where_time_goes", phase_where_time_goes, dev, setup)
    timed("cpu_vs_card", phase_cpu_vs_card, dev)
    with shapes["comms_path"]:
        comms = timed("comms_path", phase_comms_path, dev, setup)
    timed("path_shapes", phase_path_shapes, dev, shapes)
    timed("comms_scale", phase_comms_scale, dev)
    timed("comms_cpu_vs_card", phase_comms_cpu_vs_card, dev)
    lm_rows = timed("lm_kernels", phase_lm_kernels, dev)
    served = timed("serve", phase_serve, dev)
    timed("serve_cpu_vs_card", phase_serve_cpu_vs_card, dev)

    # Main-path shapes: 10 clients per flush, femnist_mlp, f32.
    fed = _pick(rows, name="fedagg", form="plain", K=10, dtype="float32")
    prox = _pick(rows, name="prox_sgd", C=10, dtype="float32", mu=0.1,
                 anchor="shared")
    # Serving shapes: hymba-1.5b bf16, 29 of its 32 layers windowed.
    flash = _pick(lm_rows, name="flash_attention", case="serve_swa",
                  dtype="bfloat16")
    wkv = _pick(lm_rows, name="wkv6", case="serve")
    kernels = []
    for row, source, replaces, launches in (
            (prox, "src/repro_torch/csrc/prox_sgd.cu",
             "src/repro/kernels/prox_sgd.py:39", main_path["launches"]),
            (fed, "src/repro_torch/csrc/fedagg.cu",
             "src/repro/kernels/fedagg.py:38", main_path["launches"]),
            (flash, "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:114", served["launches"]),
            (wkv, "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/wkv6.py:90", served["launches"])):
        kernels.append(dict(
            name=row["name"], route="cuda", source=source,
            replaces=replaces, launches=launches[row["name"]],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            # The comms path's runs, each counted from 0 (not the main
            # path's count above).
            comms_path_launches=comms["launches"].get(row["name"], 0)))
    emit("done", wall_s=time.perf_counter() - t_start, phases_s=phases_s)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
