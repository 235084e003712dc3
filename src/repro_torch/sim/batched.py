"""Batched scenario sweeps — many `ConstellationSim` scenarios per launch.

Port of `repro.sim.batched`. The paper's evidence is a 768-configuration
grid; the loop path runs it one `ConstellationSim` at a time, so every
scenario pays its own launches (one `prox_sgd` a local step over C <= 10
rows, one `fedagg` a round). This module executes a whole scenario
*batch* (same workload, different algorithms / constellations / station
networks) in two phases:

  1. **Host-side per-scenario planning** (timing phase), a numpy copy of
     the reference's: each scenario's schedule comes from a timing-only
     twin of its engine, bitwise the loop path's `RoundRecord`s.
     Synchronous no-relay scenarios advance in lockstep over one
     scenario-stacked `WindowTable` (`_plan_sync_batched`); relay,
     plan-backed, async and custom-hook scenarios run their scalar twins.

  2. **Stacked device rounds** (training phase, `cfg.train=True`). The
     scenarios' flat params are one (S, P) buffer. Each round gathers a
     (scenario, client) slab of S * Cpad rows (Cpad the batch's largest
     round; padded clients take zero steps and zero weight, finished
     scenarios ride along as all-zero rows) and runs ONE
     `vmapped_client_update` over it — one `prox_sgd` launch per local
     step, with each row's own prox_mu and anchors grouped per scenario
     (the synchronous barrier) or per client (FedBuff's historical
     versions) — then the codec round trip where the batch's codec is
     lossy, then ONE batched `fedagg` delta launch
     (`weighted_delta_update_batched`: server_lr 1 and staleness 0 reduce
     it to the synchronous weighted average). Its zero-total guard keeps
     a finished scenario's params.

Random draws go through each scenario's own sampler, in the loop engine's
order: `init`, then per trained round `minibatches` (and `codec_uniforms`
where the codec is stochastic). `minibatches` is called at the bound the
loop path would use for that scenario's round (`ConstellationSim._bound`
of its own steps), not at the batch's: a `TorchSampler` draw at a larger
bound is not a prefix of one at a smaller bound. The indices are then
padded to the batch's bound; steps past a row's budget are masked, so the
padding is never read. Per-client updates thus see the loop path's
minibatches, and the results match it within the 1e-5 envelope (the
delta form of the average rounds differently).

Evaluation replays each scenario's `_eval` per scenario, including the
final-model evaluation on truncated runs (`ConstellationSim._final_eval`).

Constraints: one batch shares a workload and the training knobs
(`train`/`lr`/`batch_size`/`max_steps`), and a training batch one device
and one codec; constellations, algorithms, station networks, horizons and
seeds are free per scenario. Strategies must aggregate within the
weighted-average / discounted-delta family; `record_params` is
unsupported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comms.codec import client_roundtrip
from repro_torch.comms.contact_plan import ContactOutlook, WindowTable
from repro_torch.core.aggregation import weighted_delta_update_batched
from repro_torch.core.client import vmapped_client_update
from repro_torch.core.selection import (
    MAX_PASS_SLIDES,
    BaseSelector,
    ClientPlan,
    ScheduleSelector,
)
from repro_torch.core.strategies.base import ClientWorkMode, Strategy
from repro_torch.core.strategies.fedbuff import FedBuffSat
from repro_torch.obs import count, enabled as obs_enabled, span
from repro_torch.params import params_to_numpy
from repro_torch.sim.engine import (
    ConstellationSim,
    buffer_weights,
    client_steps,
    sync_round_metrics,
)
from repro_torch.sim.metrics import SimResult


def _fast_plannable(sim: ConstellationSim) -> bool:
    """Scenarios the lockstep batched planner covers: the synchronous
    no-relay AccessWindows path (fedavg/fedprox + sched variants) with
    stock scheduling hooks. Relay, ContactPlan-backed, async, and
    custom-hook (connectivity-aware) scenarios plan on their scalar
    twins — the lockstep planner reproduces the one-group round barrier,
    so a strategy that times rounds differently must run its own loop."""
    sel = sim.alg.selector
    strat = type(sim.alg.strategy)
    return (sim.alg.synchronous
            and sim.plan is None
            and not sel.use_relay
            and type(sel) in (BaseSelector, ScheduleSelector)
            and strat.admit is Strategy.admit
            and strat.should_flush is Strategy.should_flush
            and strat.next_sync_point is Strategy.next_sync_point
            and sim.constellation.n_sats >= 2)


def _ground_table(sim: ConstellationSim) -> WindowTable:
    """Per-satellite merged ground windows as a rectangular WindowTable.

    Rates are informational (the AccessWindows path prices transfers with
    the flat `hw.tx_time_s`); the table exists for its batched
    `first_live` window search.
    """
    return ContactOutlook.from_access(
        sim.aw, rate_bps=sim.hw.link_mbps * 1e6).ground


@dataclasses.dataclass
class _PlanState:
    """Lockstep planner state for one scenario."""

    idx: int                      # position in the sweep batch
    sim: ConstellationSim
    twin: ConstellationSim        # timing-configured engine (record reuse)
    rows: np.ndarray              # stacked-table row per satellite
    t: float = 0.0
    done: bool = False
    rounds: list = dataclasses.field(default_factory=list)
    curve: list = dataclasses.field(default_factory=list)

    @property
    def K(self) -> int:
        return self.sim.constellation.n_sats


def _plan_sync_batched(states: list[_PlanState], table: WindowTable) -> None:
    """Advance every scenario's synchronous round loop in lockstep.

    Each iteration plans round `len(state.rounds)` for every still-active
    scenario with batched window queries over the scenario-stacked table,
    reproducing `selection._plan_prefix`/`_plan_for` (AccessWindows
    branch, no relay) bitwise — same float64 arithmetic, same bounded
    download-fit retry, same sort keys — then finishes the round through
    the twin engine's `_finish_round` so `RoundRecord` construction is
    the loop path's own code.
    """
    W = table.starts.shape[1]

    def win(rows, i):
        wi = np.minimum(i, max(W - 1, 0))
        return table.starts[rows, wi], table.ends[rows, wi]

    # Per-scenario planning constants (floats precomputed exactly as the
    # scalar selector computes them, so lane arithmetic stays bitwise).
    consts = {}
    for st in states:
        sim = st.sim
        hw, alg, cfg = sim.hw, sim.alg, sim.cfg
        fixed = alg.strategy.work_mode is ClientWorkMode.FIXED_EPOCHS
        consts[st.idx] = dict(
            tx=hw.tx_time_s,
            ep_t=hw.epoch_time_s,
            fixed=fixed,
            eft=alg.local_epochs * hw.epoch_time_s,
            emn=max(alg.min_epochs, 1) * hw.epoch_time_s,
            cap=hw.max_local_epochs,
            minf=min(alg.min_epochs, hw.max_local_epochs),
            E=alg.local_epochs,
            schedule=alg.selector.schedule,
            c=alg.strategy.round_size(min(cfg.clients_per_round, st.K)),
            # Shared round-trip pricing: full-precision download +
            # codec-priced uplink (`ul` IS `tx` for the identity codec,
            # so seed lanes stay bitwise).
            ul=hw.ul_time_s,
            comm_b=hw.round_trip_bytes,
        )

    while True:
        act = []
        for st in states:
            if st.done:
                continue
            if len(st.rounds) >= st.sim.cfg.max_rounds \
                    or st.t >= st.sim.cfg.horizon_s:
                st.done = True
                continue
            act.append(st)
        if not act or W == 0:
            for st in act:
                st.done = True   # no scenario has any window at all
            break

        def lane(key, dtype=float):
            return np.concatenate([
                np.full(st.K, consts[st.idx][key], dtype) for st in act])

        rows = np.concatenate([st.rows for st in act])
        t_l = np.concatenate([np.full(st.K, st.t) for st in act])
        tx_l = lane("tx")
        counts = table.counts[rows]

        # --- download pass (bounded fit retry, = `_plan_prefix`) -------- #
        i = table.first_live(rows, t_l)
        valid = i < counts
        s_w, e_w = win(rows, np.where(valid, i, 0))
        rx_s = np.maximum(s_w, t_l)
        rx_e = rx_s + tx_l
        for _ in range(MAX_PASS_SLIDES):
            over = valid & (rx_e > e_w)
            if not over.any():
                break
            q = e_w + 1.0
            i_new = table.first_live(rows, q)
            ok_new = i_new < counts
            s2, e2 = win(rows, np.where(ok_new, i_new, 0))
            valid = np.where(over, ok_new, valid)
            rx_s = np.where(over, np.maximum(s2, q), rx_s)
            rx_e = np.where(over, np.maximum(s2, q) + tx_l, rx_e)
            e_w = np.where(over, e2, e_w)
            i = np.where(over, i_new, i)
        valid &= ~(rx_e > e_w)   # retries exhausted: drop the candidate

        # --- training span + return window (= `_plan_for`, no relay) ---- #
        after = e_w + 1.0
        fixed_l = lane("fixed", bool)
        train_s = rx_e
        er = np.where(fixed_l,
                      np.maximum(rx_e + lane("eft"), after),
                      np.maximum(rx_e + lane("emn"), after))
        j = table.first_live(rows, er)
        rvalid = j < counts
        s_r, _ = win(rows, np.where(rvalid, j, 0))
        tx_s = np.maximum(s_r, er)
        tx_e = tx_s + lane("ul")   # return leg: codec-priced uplink
        valid &= rvalid
        # UNTIL_CONTACT epoch count: whole epochs in [train_start,
        # departure), duty-cycle capped, min-epoch floored, `or 1`.
        eb = (np.maximum(0.0, tx_s - train_s) / lane("ep_t")).astype(np.int64)
        eb = np.minimum(eb, lane("cap", np.int64))
        epu = np.maximum(eb, lane("minf", np.int64))
        epu = np.where(epu == 0, 1, epu)
        epochs_l = np.where(fixed_l, lane("E", np.int64), epu)
        train_e = np.where(fixed_l, rx_e + lane("eft"), tx_s)

        lo = 0
        for st in act:
            sl = slice(lo, lo + st.K)
            lo += st.K
            cn = consts[st.idx]
            plans = []
            for k in np.flatnonzero(valid[sl]):
                g = sl.start + int(k)
                plans.append(ClientPlan(
                    k=int(k), rx_start=float(rx_s[g]),
                    rx_end=float(rx_e[g]), train_start=float(train_s[g]),
                    train_end=float(train_e[g]), epochs=int(epochs_l[g]),
                    tx_start=float(tx_s[g]), tx_end=float(tx_e[g]),
                    comm_bytes=cn["comm_b"]))
            key = (lambda p: (p.tx_end, p.rx_start)) if cn["schedule"] \
                else (lambda p: (p.rx_start, p.tx_end))
            plans.sort(key=key)
            plans = plans[: min(cn["c"], len(plans))]
            r = len(st.rounds)
            with span("sim.round", idx=r, mode="batched_plan") as rs:
                if not plans:
                    rs.set(aborted="no_plans")
                    st.done = True
                    continue
                t_end = max(p.tx_end for p in plans)
                if t_end > st.sim.cfg.horizon_s:
                    rs.set(aborted="horizon")
                    st.done = True
                    continue
                st.twin._finish_round(
                    st.rounds, st.curve, None,
                    do_eval=(r % st.sim.cfg.eval_every == 0
                             or r == st.sim.cfg.max_rounds - 1),
                    **sync_round_metrics(plans, st.t, t_end))
                st.t = t_end


class BatchedSweep:
    """Plan + execute a batch of `ConstellationSim` scenarios together.

    `run()` returns one `SimResult` per input sim, in order. Timing-only
    batches (`cfg.train=False`) return after the planning phase — records
    bitwise the loop path's; training batches additionally run the
    stacked device rounds and carry accuracy curves + final params.
    """

    def __init__(self, sims: list[ConstellationSim],
                 names: list[str] | None = None, *,
                 batched_planning: bool = True):
        if not sims:
            raise ValueError("BatchedSweep needs at least one scenario")
        self.sims = list(sims)
        self.names = (list(names) if names is not None
                      else [f"scenario{i}" for i in range(len(sims))])
        if len(self.names) != len(self.sims):
            raise ValueError("names/sims length mismatch")
        self.batched_planning = batched_planning
        ref = self.sims[0]
        self.workload = ref.workload
        self.train = ref.cfg.train
        self.device = ref.device
        knobs = (ref.cfg.train, ref.cfg.lr, ref.cfg.batch_size,
                 ref.cfg.max_steps)
        for sim, name in zip(self.sims, self.names):
            if sim.workload.name != self.workload.name:
                raise ValueError(
                    f"scenario {name!r} runs workload "
                    f"{sim.workload.name!r}; the batch stacks "
                    f"{self.workload.name!r} parameter buffers — sweep one "
                    "workload per batch")
            if (sim.cfg.train, sim.cfg.lr, sim.cfg.batch_size,
                    sim.cfg.max_steps) != knobs:
                raise ValueError(
                    f"scenario {name!r} differs in train/lr/batch_size/"
                    "max_steps; the batched round runs one update for the "
                    "whole batch")
            if sim.cfg.record_params:
                raise ValueError("record_params is unsupported under "
                                 "BatchedSweep (parity harness: use the "
                                 "loop path)")
            if sim.execution == "mesh":
                raise ValueError(
                    f"scenario {name!r} requests mesh execution; the "
                    "batched sweep is its own stacked executor — run "
                    "mesh scenarios through the loop path")
            agg = type(sim.alg.strategy).aggregate
            if self.train and agg not in (Strategy.aggregate,
                                          FedBuffSat.aggregate):
                raise ValueError(
                    f"strategy {sim.alg.strategy.name!r} overrides "
                    "aggregate() outside the weighted-average / "
                    "staleness-discounted-delta family; the batched "
                    "masked-delta aggregation would bypass it")
            # One codec per training batch: the round slab round-trips
            # every row through one codec — sweep codecs as batches.
            if self.train and sim.codec.name != ref.codec.name:
                raise ValueError(
                    f"scenario {name!r} uses codec {sim.codec.name!r} but "
                    f"the batch runs {ref.codec.name!r}; sweep one "
                    "codec per training batch")
            if self.train and sim.device != self.device:
                raise ValueError(
                    f"scenario {name!r} trains on {sim.device} but the "
                    f"batch stacks its params on {self.device}; sweep one "
                    "device per training batch")
        self.codec = ref.codec

    # ------------------------------------------------------------------ #
    # Phase 1: host-side per-scenario planning                           #
    # ------------------------------------------------------------------ #
    def _twin(self, sim: ConstellationSim) -> ConstellationSim:
        cfg = dataclasses.replace(sim.cfg, train=False, record_params=False)
        return ConstellationSim(
            sim.constellation, sim.stations, sim.alg, data=sim.data,
            hw=sim.hw, cfg=cfg, access=sim.aw, contact_plan=sim.plan,
            workload=sim.workload, execution="host", device=sim.device)

    def plan(self) -> tuple[list[SimResult], list[ConstellationSim]]:
        """Timing phase: one schedule (= loop-path records) per scenario."""
        S = len(self.sims)
        results: list[SimResult | None] = [None] * S
        twins: list[ConstellationSim | None] = [None] * S
        fast = [i for i, sim in enumerate(self.sims)
                if self.batched_planning and _fast_plannable(sim)]
        with span("sim.batched.plan", scenarios=S, lockstep=len(fast)):
            if fast:
                tables = [_ground_table(self.sims[i]) for i in fast]
                table, offs = WindowTable.stack(tables)
                states = []
                for j, i in enumerate(fast):
                    twin = self._twin(self.sims[i])
                    twins[i] = twin
                    states.append(_PlanState(
                        idx=i, sim=self.sims[i], twin=twin,
                        rows=int(offs[j])
                        + np.arange(self.sims[i].constellation.n_sats)))
                _plan_sync_batched(states, table)
                for st in states:
                    results[st.idx] = st.twin._result(st.rounds, st.curve,
                                                      None)
            for i, sim in enumerate(self.sims):
                if results[i] is not None:
                    continue
                twin = self._twin(sim)
                twins[i] = twin
                with span("sim.batched.plan_scalar", scenario=self.names[i]):
                    results[i] = twin.run()
        return results, twins

    # ------------------------------------------------------------------ #
    # Phase 2: stacked device rounds                                     #
    # ------------------------------------------------------------------ #
    def run(self) -> list[SimResult]:
        planned, _ = self.plan()
        if not self.train:
            return planned
        return self._train_batch(planned)

    def _sync_if_traced(self) -> None:
        """Honest span walls while tracing (values untouched)."""
        if obs_enabled() and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_batch(self, planned: list[SimResult]) -> list[SimResult]:
        sims = self.sims
        # Scenarios with K < 2 never federate (their loop result is the
        # empty record set with no params); pass their planned result
        # through untouched and stack the rest.
        fed = [i for i in range(len(sims))
               if sims[i].constellation.n_sats >= 2]
        if not fed:
            return planned
        B = len(fed)
        dev = self.device
        layout = self.workload.layout
        results = list(planned)

        # Each scenario's own sampler draws its init now, as the loop
        # engine's run does first.
        G = torch.stack([sims[i]._initial_params() for i in fed])   # (B, P)
        n_rounds = [len(planned[i].rounds) for i in fed]
        R = max(n_rounds, default=0)
        if R == 0:
            for b, i in enumerate(fed):
                results[i] = dataclasses.replace(
                    planned[i], execution="batched",
                    final_params=params_to_numpy(G[b], layout))
            return results

        # Rows per scenario: the batch's largest round (no power-of-two
        # padding: nothing is compiled per shape here).
        C = max(len(rec.participants) for i in fed
                for rec in planned[i].rounds)
        N = max(sims[i].data.x.shape[1] for i in fed)
        sample = tuple(sims[fed[0]].data.x.shape[2:])
        bsz = sims[fed[0]].cfg.batch_size

        # Per-round minimum anchor version -> how far back the history
        # reaches; a suffix-min over rounds bounds what is kept.
        vmin_r = np.full(R, np.iinfo(np.int64).max)
        for b, i in enumerate(fed):
            for r, rec in enumerate(planned[i].rounds):
                lag = max(rec.staleness, default=0)
                vmin_r[r] = min(vmin_r[r], r - lag)
        vmin_r = np.minimum(vmin_r, np.arange(R))
        keep_from = np.minimum.accumulate(vmin_r[::-1])[::-1]

        hist = {0: G}
        curves: list[list] = [[] for _ in fed]
        # Synchronous strategies aggregate by the weighted average, which
        # has no server-lr knob: 1.0 reduces the delta form to it.
        slr = torch.tensor(
            [1.0 if sims[i].alg.synchronous
             else getattr(sims[i].alg.strategy, "server_lr", 1.0)
             for i in fed], dtype=torch.float32, device=dev)
        prox = torch.tensor(
            [sims[i].alg.strategy.prox_mu for i in fed],
            dtype=torch.float32, device=dev).repeat_interleave(C)
        stochastic = self.codec.lossy and self.codec.stochastic

        for r in range(R):
            active = [b for b in range(B) if r < n_rounds[b]]
            steps = np.zeros((B, C), np.int32)
            vs = np.full((B, C), r, np.int64)
            # Each scenario's weights and staleness as its own run passes
            # them to the aggregation; a finished scenario has none.
            weights = [np.zeros(0, np.float32)] * B
            stale = [np.zeros(0, np.int32)] * B
            x = torch.zeros((B, C, N) + sample, device=dev)
            y = torch.zeros((B, C, N), dtype=torch.long, device=dev)
            draws = {}
            for b in active:
                sim = sims[fed[b]]
                rec = results[fed[b]].rounds[r]
                ks = rec.participants
                n = len(ks)
                data = sim.data
                st = np.asarray(rec.staleness, np.int64)
                steps[b, :n] = [client_steps(int(data.n[k]), e,
                                             sim.cfg.batch_size,
                                             sim.cfg.max_steps)
                                for k, e in zip(ks, rec.epochs)]
                weights[b] = np.asarray([float(data.n[k]) for k in ks],
                                        np.float32)
                stale[b] = st.astype(np.int32)
                if not sim.alg.synchronous:
                    weights[b] = buffer_weights(
                        weights[b], stale[b], sim.alg.strategy.max_staleness)
                    vs[b, :n] = r - st
                rows = torch.as_tensor(ks, device=dev)
                nb = data.x.shape[1]
                x[b, :n, :nb] = sim._x[rows]
                y[b, :n, :nb] = sim._y[rows]
                # This scenario's draws, at the loop path's own bound.
                idx = sim.sampler.minibatches(
                    [int(data.n[k]) for k in ks],
                    ConstellationSim._bound(steps[b, :n]), bsz)
                u = (sim.sampler.codec_uniforms(n, layout) if stochastic
                     else None)
                draws[b] = (idx, u)
            bound = ConstellationSim._bound(np.maximum(steps, 1))
            idx = torch.zeros((B, C, bound, bsz), dtype=torch.long,
                              device=dev)
            for b, (ib, _) in draws.items():
                idx[b, :ib.shape[0], :ib.shape[1]] = ib

            with span("sim.round", idx=r, mode="batched",
                      scenarios=len(active)):
                if int(vs.min()) >= r:
                    # Everyone anchors on its scenario's current model:
                    # one anchor row per scenario, no broadcast.
                    anchors = G
                    params0 = G.repeat_interleave(C, dim=0)
                else:
                    v_lo = int(keep_from[r])
                    vstk = torch.stack([hist[v]
                                        for v in range(v_lo, r + 1)])
                    vrel = torch.as_tensor(vs - v_lo, device=dev)
                    bidx = torch.arange(B, device=dev)[:, None]
                    anchors = vstk[vrel, bidx].reshape(B * C, -1)
                    params0 = anchors
                update = vmapped_client_update(
                    self.workload.loss_fn, lr=sims[0].cfg.lr,
                    batch_size=bsz, max_steps=bound, layout=layout)
                with span("sim.client_train", mode="batched",
                          scenarios=len(active), step_bound=bound):
                    out = update(params0, anchors, x.flatten(0, 1),
                                 y.flatten(0, 1), steps.reshape(-1).tolist(),
                                 prox, idx.flatten(0, 1))
                    if self.codec.lossy:
                        # The loop engine's per-client round trip, on
                        # every row; padded rows decode garbage that
                        # their zero weight discards.
                        u = None
                        if stochastic:
                            u = torch.zeros_like(out).view(B, C, -1)
                            for b, (_, ub) in draws.items():
                                u[b, :ub.shape[0]] = ub
                            u = u.view(B * C, -1)
                        full = (anchors if anchors.shape[0] == B * C
                                else anchors.repeat_interleave(C, dim=0))
                        out = client_roundtrip(self.codec, out, full,
                                               layout, u)
                    self._sync_if_traced()
                with span("sim.aggregate", mode="batched",
                          scenarios=len(active)):
                    # A finished scenario (no weights) takes the delta
                    # form, whose zero-total guard keeps its params.
                    G = weighted_delta_update_batched(
                        G, out.view(B, C, -1),
                        [torch.as_tensor(v, device=dev) for v in weights],
                        [torch.as_tensor(v, device=dev) for v in stale],
                        slr, [not (sims[i].alg.synchronous and len(weights[b]))
                              for b, i in enumerate(fed)])
                    self._sync_if_traced()
                hist[r + 1] = G
                if r + 1 < R:
                    lo = int(keep_from[r + 1])
                    for v in [v for v in hist if v < lo]:
                        del hist[v]
                else:
                    hist.clear()

                for b in active:
                    i = fed[b]
                    sim, rec = sims[i], results[i].rounds[r]
                    if sim.alg.synchronous:
                        do_eval = (r % sim.cfg.eval_every == 0
                                   or r == sim.cfg.max_rounds - 1)
                    else:
                        do_eval = r % sim.cfg.eval_every == 0
                    # Truncated runs evaluate their final model too —
                    # the engine's exit-path eval (`_final_eval`).
                    do_eval = do_eval or r == n_rounds[b] - 1
                    if not do_eval:
                        continue
                    with span("sim.eval", round=r, trained=True,
                              mode="batched"):
                        rec.accuracy = sim._eval(G[b], rec.t_end)
                        curves[b].append((r, rec.t_end, rec.accuracy))
                        count("sim.evals")

        for b, i in enumerate(fed):
            results[i] = dataclasses.replace(
                results[i], accuracy_curve=curves[b], execution="batched",
                final_params=params_to_numpy(G[b], layout))
        return results


def run_batched(sims: list[ConstellationSim],
                names: list[str] | None = None, **kwargs) -> list[SimResult]:
    """One-call convenience: `BatchedSweep(sims, names).run()`."""
    return BatchedSweep(sims, names, **kwargs).run()
