"""Multi-rank helpers for the port's mesh tests (not a test module).

`spawn` starts `nprocs` CPU processes (`torch.multiprocessing`, spawn
start method) that join one gloo process group through a `FileStore` in
the test's own temporary directory, each running one of the `*_rank`
functions below, and fails the test if any rank raises or the whole
spawn outlives its timeout. Each rank writes what it computed to
`out_dir/rank{r}.pt`; the test compares those files with the reference.
This module imports the port and torch only, so that the spawned
processes start without jax.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 60.0


def spawn(fn, nprocs: int, out_dir: str, *args,
          timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run fn(rank, nprocs, store_path, out_dir, *args) on `nprocs` ranks;
    returns the ranks' results, in rank order."""
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_main, args=(fn, nprocs, store, out_dir, args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: {nprocs} ranks still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(nprocs)]


def _main(rank: int, fn, nprocs: int, store: str, out_dir: str, args):
    # One thread each and a lower priority: the suite's other workers,
    # some timing threads, share the machine with the spawned ranks.
    os.nice(10)
    torch.set_num_threads(1)
    dist.init_process_group(
        "cpu:gloo", store=dist.FileStore(store, nprocs), rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=60))
    try:
        out = fn(rank, nprocs, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def engine_rank(rank: int, nprocs: int, cst, st, aw, data, cfg, names):
    """The mesh runs of `names` on every rank (the default group)."""
    from repro_torch.core import ALGORITHMS
    from repro_torch.sharding import COLLECTIVES
    from repro_torch.sim import ConstellationSim

    out = {}
    for name in names:
        res = ConstellationSim(cst, st, ALGORITHMS[name], data=data,
                               cfg=cfg, access=aw, device="cpu",
                               execution="mesh").run()
        out[name] = res
    out["collectives"] = dict(COLLECTIVES)
    return out


def fl_round_rank(rank: int, nprocs: int, cfg, params_np, tokens, weights,
                  steps, staleness, kw):
    """One `make_fl_round_step` round of an LM config, one pod a rank."""
    from repro_torch.launch.fl_round import make_fl_round_step
    from repro_torch.models.lm.params import lm_params_from_jax, \
        lm_params_to_numpy

    params = lm_params_from_jax(params_np, device="cpu")
    step = make_fl_round_step(cfg, **kw)
    out = step(params, {"tokens": torch.as_tensor(tokens)}, weights,
               steps=steps, staleness=staleness)
    return lm_params_to_numpy(out)


def moe_ep_rank(rank: int, nprocs: int, cfg, p_np, x, mlp_kind, splits):
    """`apply_moe_ep` on this rank's shard of x for every group size in
    `splits` (the world, then groups of consecutive ranks): output, aux,
    and the gradients of sum(y ** 2) + load_balance + router_z (the
    group-mean aux, as the training loss adds it) in x, the expert
    weights and the router."""
    from repro_torch.models.lm.moe import apply_moe_ep
    from repro_torch.models.lm.params import lm_params_from_jax

    out = {}
    for size in splits:
        groups = [dist.new_group(list(range(g, g + size)))
                  for g in range(0, nprocs, size)]
        group = groups[rank // size]
        p = lm_params_from_jax(p_np, device="cpu")
        b_loc = x.shape[0] // size
        r = dist.get_rank(group)
        g0 = (rank // size) * size     # first rank of my group
        x_loc = torch.as_tensor(
            x[(rank - g0) * b_loc:(rank - g0 + 1) * b_loc].copy(),
            dtype=torch.float32).requires_grad_(True)
        weights = [p["w1"], p["w2"], p["w3"], p["router"]]
        for w in weights:
            w.requires_grad_(True)
        y, aux = apply_moe_ep(p, x_loc, cfg, mlp_kind, group)
        loss = (y ** 2).sum() + aux["load_balance"] + aux["router_z"]
        gx, g1, g2, g3, gr = torch.autograd.grad(loss, [x_loc] + weights)
        out[size] = dict(rank=r, y=y.detach().numpy(),
                         aux={k: float(v) for k, v in aux.items()},
                         gx=gx.numpy(), gw=[g.numpy() for g in (g1, g2, g3)],
                         gr=gr.numpy())
    return out
