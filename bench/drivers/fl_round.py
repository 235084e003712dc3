"""Driver of the federated round: `repro_torch.launch.fl_round.
make_fl_round_step` on one pod of a one-rank process group, closed loop
(one satellite's round at a time, each round's output the next round's
global weights).

Set-up loads the kernel library (built into `build/kernels/` of the
checkout on a first run, which `kernels_built` reports: its nvcc time is
the "kernels" phase of `setup_phases`), makes the weights on the device from the seed
(`bench.weights`) and drives the round from them through the mix's
`check_rounds` first rounds, on batches of the mix's feed
(`bench.traffic`): the same call and feed as the window, which then
carries on from the state they leave. Those rounds warm every shape the
window uses. Set-up ends by drawing the window's batches. The window runs whole rounds back to back until `seconds`
have passed, each ending in a device synchronise.

The round's loss is the program's `lm_loss` as the round calls it with a
config; it is passed as `loss_fn` so that each local step's loss can be
kept (a detached scalar, read after the window).

With `trace`, the window is followed by `model_step_ms`'s timing (the
program's `lm_loss` and `torch.autograd.grad` alone, on the round's own
batch and weights) and by one round under `torch.profiler`.

After the window, with the program's state freed, the plain reference
follows the set-up rounds from the same seed-made weights and batches,
and `bench.check` compares the two.
"""
from __future__ import annotations

import sys
import time

import torch

from bench import harness, trace, traffic, weights
from bench.counts import kernels, model

MODEL_STEP_REPS = 3


def _leaf_change_norms(after, before) -> list[float]:
    a, b = harness.tree_items(after), harness.tree_items(before)
    return [float((x.float() - y.float()).double().norm())
            for (_, x), (_, y) in zip(a, b)]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Round:
    """The program's round for one cell, with its loss kept."""

    def __init__(self, cell: harness.Cell):
        from repro_torch.launch.fl_round import make_fl_round_step
        from repro_torch.models.lm.transformer import init_params
        from repro_torch.train.step import lm_loss

        self.cfg = harness.port_config(cell.config)
        self.lm_loss = lm_loss
        self.losses: list[torch.Tensor] = []
        self.layout = init_params(self.cfg, None, "meta")
        mix = cell.traffic
        if mix["pods"] != 1:
            raise ValueError("the fl_round driver runs one pod on one rank")
        self.pod_weights = [float(mix["rows"] * mix["seq"])]

        def loss_fn(params, batch):
            loss = lm_loss(self.cfg, params, batch)[0]
            self.losses.append(loss.detach())
            return loss

        self.step = make_fl_round_step(
            loss_fn=loss_fn, lr=mix["lr"], local_steps=mix["local_steps"],
            prox_mu=mix["prox_mu"], server_lr=mix["server_lr"])

    def __call__(self, params, tokens):
        return self.step(params, {"tokens": tokens}, self.pod_weights)

    def take_losses(self) -> list[torch.Tensor]:
        out, self.losses = self.losses, []
        return out


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device, t_start: float) -> dict:
    harness.program_path()
    mix = cell.traffic
    dtype = getattr(torch, cell.config["param_dtype"])
    phases = {"start": time.perf_counter() - t_start}

    def phase(name):
        _sync(device)
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    built = False
    if device.type == "cuda":
        from repro_torch.kernels import build
        cached = set(build.BUILD_DIR.glob("*.so"))
        build.library()
        built = set(build.BUILD_DIR.glob("*.so")) != cached
    phase("kernels")
    from repro_torch.sharding.compat import default_group
    default_group(device)
    rnd = Round(cell)
    phase("program")
    params0 = weights.make(rnd.layout, cell.config["init"], seed, device,
                           dtype)
    feed = traffic.TokenFeed(mix, rnd.cfg.vocab_size, seed, device)
    feed.fill(mix["check_rounds"])
    phase("weights")

    # Set-up: the first rounds from the seed, through the window's call
    # and feed; they warm every shape the window runs.
    params, changes = params0, []
    for i in range(mix["check_rounds"]):
        params = rnd(params, feed.next())
        changes.append(_leaf_change_norms(params, params0))
        phase(f"round{i + 1}")
    program = {"losses": [float(x) for x in rnd.take_losses()],
               "change_norms": [changes[0], changes[-1]]}
    del params0, changes
    # The window's batches, drawn ahead: half again as many as its rounds
    # would need at the last set-up round's pace (a round that finds the
    # pool empty draws its own batch).
    pace = phases[f"round{mix['check_rounds']}"]
    feed.fill(int(1.5 * seconds / pace) + 4 + (MODEL_STEP_REPS if traced
                                               else 0))
    phase("batches")
    setup_s = time.perf_counter() - t_start

    # The window.
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    walls, failed, attempted = [], 0, 0
    t0 = time.perf_counter()
    while True:
        r0 = time.perf_counter()
        attempted += 1
        try:
            params = rnd(params, feed.next())
            _sync(device)
        except RuntimeError as e:          # counted, and the window ends
            print(f"round {attempted} raised: {e!r}", file=sys.stderr,
                  flush=True)
            failed += 1
            break
        walls.append(time.perf_counter() - r0)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    losses = rnd.take_losses()
    per = mix["local_steps"]
    if losses:
        bad = ~torch.isfinite(torch.stack(losses).view(-1, per)).all(1)
        failed += int(bad.sum())
    done = len(walls)
    samples = done * per * mix["rows"] * mix["seq"]

    out = {"attempted": attempted, "failed": failed,
           "setup_phases": phases, "kernels_built": built,
           "round_walls": walls, "memory_peak_bytes": peak,
           "end_to_end": {
               "client_samples_per_s": samples / window_s if done else 0.0,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if traced:
        out.update(_traced(rnd, params, feed, device))
    del params, rnd
    out["program"] = program
    return out


def _traced(rnd, params, feed, device) -> dict:
    """model_step_ms's timing, then rounds under the profiler."""
    tokens = feed.next()
    batch = {"tokens": tokens}
    leaves = [t for _, t in harness.tree_items(params)]
    step_s = []
    for _ in range(MODEL_STEP_REPS):
        t0 = time.perf_counter()
        for t in leaves:
            t.requires_grad_(True)
        try:
            grads = torch.autograd.grad(rnd.lm_loss(rnd.cfg, params,
                                                    batch)[0], leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        del grads
        _sync(device)
        step_s.append(time.perf_counter() - t0)
    from repro_torch.kernels import ops
    ops.reset_launches()
    prof = trace.profile_round(lambda tokens: rnd(params, tokens),
                               feed.next, device,
                               lambda: dict(ops.LAUNCHES))
    rnd.take_losses()
    return {"model_step_s": step_s, "trace": prof}


def observations(cell: harness.Cell, out: dict) -> dict:
    """What the per-layer readers read: the driver's timings and trace,
    and the counts of the configuration at the mix's shapes."""
    mix = cell.traffic
    m = cell.config["model"]
    return {"round_walls": out["round_walls"],
            "model_step_s": out.get("model_step_s"),
            "trace": out.get("trace"),
            "launches": (out.get("trace") or {}).get("launches", {}),
            "local_steps": mix["local_steps"],
            "step_flops": model.step_flops(m, mix["rows"],
                                           mix["seq"])["total"],
            "launch_bounds": kernels.launches(m, mix["rows"], mix["seq"])}


def reference_rounds(cell: harness.Cell, seed: int, device,
                     mm_name: str = "float32") -> dict:
    """The plain reference's rounds (`bench/reference/_round.py`) from the
    seed's weights and batches, with matrix products in `mm_name`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    harness.program_path()
    from repro_torch.models.lm.transformer import init_params

    mix = cell.traffic
    cfg = harness.port_config(cell.config)
    dtype = getattr(torch, cell.config["param_dtype"])
    params0 = weights.make(init_params(cfg, None, "meta"),
                           cell.config["init"], seed, device, dtype)
    feed = traffic.TokenFeed(mix, cell.config["model"]["vocab_size"], seed,
                             device)
    batches = [feed.next() for _ in range(mix["check_rounds"])]
    plain = harness.load_module(harness.BENCH / "reference" / "_plain.py")
    rounds = harness.load_module(harness.BENCH / "reference" / "_round.py")
    return rounds.run_rounds(
        cell.reference.loss_sum, cell.config["model"], params0, batches,
        lr=mix["lr"], prox_mu=mix["prox_mu"],
        local_steps=mix["local_steps"], server_lr=mix["server_lr"],
        pod_weights=[float(mix["rows"] * mix["seq"])], param_dtype=dtype,
        mm=plain.MATMULS[mm_name])
