"""ConstellationSim — event-driven execution of a space-ified FL algorithm.

Port of `repro.sim.engine` with host execution. It couples orbital
geometry (`repro_torch.orbits`: who can talk to whom, when), the
communications layer (`repro_torch.comms`: link rates, ISL contact
windows, relay routing, uplink codecs; a `ContactPlan` is built only for
`isl=True` algorithms or explicit link models), the FL algorithm
(`repro_torch.core`: selection + client regime + aggregation) and the
workload (`repro_torch.core.workload`: what the satellites train), and
produces the paper's three metrics per round: accuracy, round duration,
and per-satellite idle time.

One strategy-driven event loop (`_run_events`) executes every algorithm
through two event feeds — the synchronous selection barrier of
Algorithms 1-2 and the asynchronous upload heap of Algorithm 3 — whose
control flow matches the reference line for line, so the port's
RoundRecords equal the reference's bitwise on the same access windows.

Tensor work runs on `device` (cuda unless the caller passes "cpu"). The
dataset is moved to the device once and rounds gather their clients by
index there. Each round trains its whole client stack as one (C, P) flat
buffer — one `prox_sgd` launch per local step — and aggregates it with
one `fedagg` launch. A lossy uplink codec round-trips the stack between
the two (`repro_torch.comms.codec`). Random draws (initial params,
minibatch indices, the codec's stochastic-rounding uniforms) come from a
`sampler`; the default `TorchSampler` holds one `torch.Generator`.

`_train_round` dispatches on the execution mode (a `Workload` capability,
overridable per run with `ConstellationSim(..., execution=...)`):

  * "host" — the stack above, then `Strategy.aggregate`;
  * "mesh" — cluster-as-collective (`launch.fl_round.make_mesh_round_step`):
    each participating satellite is a pod slot of the ranks of a
    `torch.distributed` group (`sharding.client_mesh`; a one-rank group
    when the program has none), each rank trains its block of slots, and
    aggregation is one participation-masked, weighted all-reduce. Covers
    every strategy in the (weighted-average / staleness-discounted
    weighted-delta, server-lr) family, i.e. the whole registered suite;
    a custom `Strategy.aggregate` outside that family must run on "host".
    Every rank runs the whole event loop and makes the same draws, so
    all ranks agree on every record; one rank is bitwise the host path.

The workloads are `femnist_mlp`, `femnist_cnn`, `lm_tiny`,
`lm_hybrid_tiny`, `lm_rwkv6_tiny` and `lm_moe_tiny`.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.comms.codec import client_roundtrip, get_codec
from repro_torch.comms.contact_plan import (
    ContactOutlook,
    ContactPlan,
    build_contact_plan,
)
from repro_torch.comms.isl import ISLTopology, compute_isl_windows
from repro_torch.comms.links import ConstantRate, LinkModel
from repro_torch.core.aggregation import admission_weights
from repro_torch.core.client import vmapped_client_update
from repro_torch.core.spaceify import SpaceifiedAlgorithm
from repro_torch.core.strategies.base import BufferState, PendingUpdate, \
    Strategy
from repro_torch.core.strategies.fedbuff import FedBuffSat
from repro_torch.core.timing import HardwareModel
from repro_torch.core.workload import Workload, get_workload, \
    validate_execution
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.launch.fl_round import make_mesh_round_step
from repro_torch.obs import count, enabled as obs_enabled, span
from repro_torch.orbits.access import AccessWindows, compute_access_windows
from repro_torch.orbits.walker import WalkerStar
from repro_torch.params import ParamLayout, params_from_jax, \
    params_to_numpy
from repro_torch.sharding.flmesh import client_mesh, pad_client_count
from repro_torch.sim.metrics import RoundRecord, SimResult


@dataclasses.dataclass(frozen=True)
class SimConfig:
    max_rounds: int = 500            # paper: 500-round cap
    horizon_s: float = 90 * 86400.0  # paper: 3-month scenario
    clients_per_round: int = 10      # C
    batch_size: int = 32
    lr: float = 0.05
    eval_every: int = 5              # rounds between evaluations
    max_steps: int = 128             # static bound on local SGD steps/round
    seed: int = 0
    train: bool = True               # False: timing-only sweep (no gradients)
    record_params: bool = False      # keep a per-round global-params history


class TorchSampler:
    """The engine's default random source: one `torch.Generator` on the
    device, seeded once.

    `init(workload)` gives the initial flat params; `minibatches(n_valid,
    bound, batch_size)` gives one training round's (C, bound, B) int64
    minibatch indices, client c's drawn uniformly from
    [0, max(n_valid[c], 1)); `codec_uniforms(n_clients, layout)` gives the
    (C, P) float32 uniforms of one stochastic-rounding codec round-trip of
    that round's client stack. The engine calls `minibatches` once per
    training round, in the order the reference splits its PRNG key, and
    `codec_uniforms` right after it in rounds that round-trip a
    stochastic codec, so a sampler that replays the reference's draws
    reproduces its runs.
    """

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def init(self, workload: Workload) -> torch.Tensor:
        return workload.init_fn(self.generator, self.device)

    def minibatches(self, n_valid: Sequence[int], bound: int,
                    batch_size: int) -> torch.Tensor:
        n = torch.tensor([max(int(v), 1) for v in n_valid],
                         dtype=torch.float64, device=self.device)
        u = torch.rand((len(n_valid), bound, batch_size),
                       generator=self.generator, dtype=torch.float64,
                       device=self.device)
        top = (n - 1).long()[:, None, None]
        return torch.minimum((u * n[:, None, None]).long(), top)

    def codec_uniforms(self, n_clients: int,
                       layout: ParamLayout) -> torch.Tensor:
        return torch.rand((n_clients, layout.size), generator=self.generator,
                          dtype=torch.float32, device=self.device)


def client_steps(n_k: int, epochs: int, batch_size: int,
                 max_steps: int) -> int:
    """Local SGD steps for a client with `n_k` samples running `epochs`
    epochs: `epochs * max(1, n_k // batch_size)`, clipped to [1, max_steps]."""
    spe = max(1, n_k // batch_size)
    return int(np.clip(epochs * spe, 1, max_steps))


def sync_round_metrics(plans, t_start: float, t_end: float) -> dict:
    """Per-satellite round metrics from a synchronous round's ClientPlans —
    the kwargs `_finish_round` consumes."""
    return dict(
        t_start=t_start, t_end=t_end,
        participants=[p.k for p in plans],
        epochs=[p.epochs for p in plans],
        idle_s=[max(0.0, (t_end - t_start)
                    - (p.rx_end - p.rx_start)
                    - (p.train_end - p.train_start)
                    - (p.tx_end - p.tx_start)) for p in plans],
        compute_s=[p.train_end - p.train_start for p in plans],
        comm_s=[(p.rx_end - p.rx_start)
                + (p.tx_end - p.tx_start) for p in plans],
        relays=[p.relay for p in plans],
        staleness=[0] * len(plans),
        relay_hops=[p.isl_hops for p in plans],
        comms_bytes=[p.comm_bytes for p in plans],
    )


def buffer_weights(ns: np.ndarray, staleness: np.ndarray,
                   max_staleness: int) -> np.ndarray:
    """FedBuff admission: updates staler than the bound get zero weight."""
    return admission_weights(ns, staleness, max_staleness)


def prune_history(history: dict, outstanding: Iterable[int],
                  version: int) -> None:
    """Drop global-model versions no in-flight client still anchors on
    (versions >= min(outstanding) survive; with nothing in flight only
    the current `version`). Mutates `history` in place."""
    keep_from = min(outstanding, default=version)
    for v in list(history):
        if v < keep_from:
            del history[v]


class ConstellationSim:
    """Run one (constellation x network x algorithm x workload) scenario."""

    def __init__(
        self,
        constellation: WalkerStar,
        stations,
        algorithm: SpaceifiedAlgorithm,
        data: FederatedDataset | None = None,
        hw: HardwareModel | None = None,
        cfg: SimConfig | None = None,
        access: AccessWindows | None = None,
        contact_plan: ContactPlan | None = None,
        link_model: LinkModel | None = None,
        isl_link: LinkModel | None = None,
        isl_topology: ISLTopology | None = None,
        workload: Workload | str | None = None,
        execution: str | None = None,
        *,
        device: str | torch.device | None = None,
        sampler=None,
        init_params: dict | None = None,
    ):
        self.constellation = constellation
        self.stations = stations
        self.alg = algorithm
        self.cfg = cfg or SimConfig()
        self.device = resolve_device(device)
        self.workload = get_workload(
            workload if workload is not None else "femnist_mlp")
        if self.cfg.train and self.workload.train_refusal is not None:
            raise ValueError(
                f"workload {self.workload.name!r} prices but cannot train: "
                f"{self.workload.train_refusal}; run it timing-only "
                "(SimConfig(train=False))")
        # Hardware: explicit > workload-derived > paper constants (the
        # `femnist_mlp` workload's pinned cost makes all three identical).
        if hw is not None:
            self.hw = hw
        elif workload is not None:
            self.hw = HardwareModel.for_workload(self.workload)
        else:
            self.hw = HardwareModel()
        # Uplink transfer codec: the algorithm's knob resolves to a
        # registry codec and rides inside the HardwareModel, so every
        # wire-pricing consumer prices encoded uplinks. "identity" leaves
        # the HardwareModel untouched (the seed's pricing, bit for bit); a
        # caller-supplied `hw` that carries a codec keeps it unless the
        # algorithm names a lossy one.
        self.codec = get_codec(algorithm.codec)
        if self.codec.name != "identity":
            self.hw = dataclasses.replace(
                self.hw, codec=self.codec,
                bytes_per_param=int(self.workload.bytes_per_param))
        elif self.hw.codec is not None:
            self.codec = self.hw.codec
        self.data = data
        if access is not None:
            self.aw = access
        else:
            with span("sim.access_windows", sats=constellation.n_sats):
                self.aw = compute_access_windows(
                    constellation, stations, horizon_s=self.cfg.horizon_s,
                    device=self.device)
        # Comms: algorithms marked `isl=True` (or an explicit link model)
        # plan against a ContactPlan; everything else keeps the
        # AccessWindows-only path, bit for bit.
        self.plan = contact_plan
        if self.plan is not None and (link_model is not None
                                      or isl_link is not None):
            # A cached plan is geometry, not pricing: re-rate it with the
            # requested link models (a lone link_model prices both sides;
            # a lone isl_link re-prices ISLs and keeps the ground pricing).
            self.plan = self.plan.rerate(link_model, isl_link)
        elif self.plan is None and (algorithm.isl or link_model is not None):
            ground = link_model or ConstantRate(self.hw.link_mbps)
            iw = None
            if algorithm.isl:
                topo = isl_topology or ISLTopology.walker_star(constellation)
                iw = compute_isl_windows(constellation, topo,
                                         horizon_s=self.cfg.horizon_s,
                                         device=self.device)
            self.plan = build_contact_plan(
                self.aw, iw, ground, isl_link or ground,
                constellation=constellation, stations=stations)
        self.execution = validate_execution(
            execution or self.workload.execution)
        if self.execution == "mesh":
            # The mesh round step stacks one (x, y) sample stream per pod
            # slot. A workload whose launch-style dict-batch schema
            # declares extra streams (prefix/encoder embeddings) cannot
            # be expressed that way: refuse instead of silently dropping
            # the extra keys.
            dims = self.workload.mesh_batch_dims
            streams = [k for k in (dims or {}) if k != "labels"]
            if len(streams) > 1:
                raise ValueError(
                    f"workload {self.workload.name!r} declares a "
                    f"multi-stream mesh batch schema {sorted(dims)}; the "
                    "engine's mesh path carries a single (x, y) sample "
                    "stream per pod slot — run with execution='host' or "
                    "drive launch.fl_round.make_fl_round_step directly")
            # The collective realizes exactly the weighted-average /
            # discounted-delta family; a custom Strategy.aggregate would
            # be silently bypassed, so refuse instead.
            agg = type(algorithm.strategy).aggregate
            if agg not in (Strategy.aggregate, FedBuffSat.aggregate):
                raise ValueError(
                    f"strategy {algorithm.strategy.name!r} overrides "
                    "aggregate() outside the weighted-average / "
                    "staleness-discounted-delta family; mesh execution "
                    "would bypass it — run with execution='host'")
            # The collective rounds as the strategy's own form does (the
            # synchronous average, or FedBuff's discounted delta).
            self._mesh_delta = agg is FedBuffSat.aggregate
        self.sampler = sampler or TorchSampler(self.cfg.seed, self.device)
        self.init_params = init_params
        self._params_hist: list = []
        if self.cfg.train:
            if self.data is None:
                self.data = self.workload.make_data(constellation.n_sats,
                                                    seed=self.cfg.seed)
            if self.data.n_clients != constellation.n_sats:
                raise ValueError(
                    f"dataset has {self.data.n_clients} clients for "
                    f"{constellation.n_sats} satellites")
            # The dataset lives on the device once; rounds gather their
            # clients by index there.
            # Token shards (int32, as the reference stores them) are
            # indices, which torch takes as int64.
            dev = self.device
            as_x = lambda a: (torch.as_tensor(a, device=dev).long()
                              if np.issubdtype(a.dtype, np.integer)
                              else torch.as_tensor(a, device=dev))
            self._x = as_x(self.data.x)
            self._y = torch.as_tensor(self.data.y, device=dev).long()
            self._x_eval = as_x(self.data.x_eval)
            self._y_eval = torch.as_tensor(self.data.y_eval,
                                           device=dev).long()

    def _sync_if_traced(self) -> None:
        """Honest span walls while tracing (values untouched)."""
        if obs_enabled() and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _bound(steps: np.ndarray | list[int]) -> int:
        m = max(int(np.max(steps)), 1)
        return 1 << (m - 1).bit_length()

    # ------------------------------------------------------------------ #
    def run(self) -> SimResult:
        K = self.constellation.n_sats
        if K < 2:
            # A single satellite cannot federate (heatmap top-left = 0).
            return self._result([], [], None)
        return self._run_events()

    # ------------------------------------------------------------------ #
    def _steps_for(self, k: int, epochs: int) -> int:
        n_k = int(self.data.n[k]) if self.data is not None else 256
        return client_steps(n_k, epochs, self.cfg.batch_size,
                            self.cfg.max_steps)

    # ------------------------------------------------------------------ #
    # Shared round-execution core (sync barrier AND async buffer flushes)
    # ------------------------------------------------------------------ #
    def _run_clients(self, global_params: torch.Tensor, ks: list[int],
                     epochs: list[int],
                     anchors: torch.Tensor | None = None) -> torch.Tensor:
        """Train-batch assembly + ClientUpdate over the stack of `ks`.

        `anchors` is None for the synchronous barrier (everyone anchors on
        the current global model, broadcast) or the (C, P) stack of
        per-client anchor versions (FedBuff). Returns the (C, P) client
        parameter returns.
        """
        steps_np = [self._steps_for(k, e) for k, e in zip(ks, epochs)]
        rows = torch.as_tensor(ks, device=self.device)
        x = self._x[rows]
        y = self._y[rows]
        if anchors is None:
            anchors = global_params
            params0 = global_params.expand(len(ks), -1)
        else:
            params0 = anchors
        bound = self._bound(steps_np)
        idx = self.sampler.minibatches([int(self.data.n[k]) for k in ks],
                                       bound, self.cfg.batch_size)
        update = vmapped_client_update(
            self.workload.loss_fn, lr=self.cfg.lr,
            batch_size=self.cfg.batch_size, max_steps=bound,
            layout=self.workload.layout)
        with span("sim.client_train", clients=len(ks), step_bound=bound):
            out = update(params0, anchors, x, y, steps_np,
                         self.alg.strategy.prox_mu, idx)
            self._sync_if_traced()
        return out

    def _run_clients_mesh(self, global_params: torch.Tensor, ks: list[int],
                          epochs: list[int], *, weights, staleness,
                          anchors: torch.Tensor | None = None
                          ) -> torch.Tensor:
        """Cluster-as-collective round: clients are pod slots on the
        client mesh; local SGD and aggregation happen in one round step
        (`launch.fl_round.make_mesh_round_step`). Returns the *new global
        params*: aggregation is part of the collective.

        The draws are the host path's (`_run_clients`, then
        `_codec_roundtrip`), in the same order and for the real clients
        only; the pod axis is then padded to a multiple of the mesh size
        with zero-weight, zero-step slots that repeat `ks[0]`'s rows (the
        dense equivalent of an out-of-contact satellite), and FedBuff's
        anchors with the current global model.
        """
        steps_np = [self._steps_for(k, e) for k, e in zip(ks, epochs)]
        mesh = client_mesh(device=self.device)
        total = pad_client_count(len(ks), mesh)
        pad = total - len(ks)
        bound = self._bound(steps_np)
        idx = self.sampler.minibatches([int(self.data.n[k]) for k in ks],
                                       bound, self.cfg.batch_size)
        layout = self.workload.layout
        u = (self.sampler.codec_uniforms(len(ks), layout)
             if self.codec.lossy and self.codec.stochastic else None)

        def padded(t: torch.Tensor) -> torch.Tensor:
            return torch.cat([t, t[:1].expand(pad, *t.shape[1:])]) if pad \
                else t

        rows = torch.as_tensor(list(ks) + [ks[0]] * pad, device=self.device)
        dev = self.device
        w = torch.cat([torch.as_tensor(weights, dtype=torch.float32,
                                       device=dev),
                       torch.zeros((pad,), dtype=torch.float32, device=dev)])
        stale = torch.cat([torch.as_tensor(staleness, device=dev).long(),
                           torch.zeros((pad,), dtype=torch.long,
                                       device=dev)])
        if anchors is None:                  # sync barrier: one anchor
            anchors = global_params
        elif pad:                            # FedBuff: pad with current
            anchors = torch.cat([anchors,
                                 global_params.expand(pad, -1)])
        step_fn = make_mesh_round_step(
            self.workload.loss_fn, mesh, lr=self.cfg.lr,
            batch_size=self.cfg.batch_size, max_steps=bound,
            server_lr=getattr(self.alg.strategy, "server_lr", 1.0),
            layout=layout, codec=self.codec if self.codec.lossy else None,
            delta=self._mesh_delta)
        with span("sim.client_train", mode="mesh", clients=len(ks),
                  slots=total, ranks=mesh.size, step_bound=bound):
            out = step_fn(global_params, anchors, self._x[rows],
                          self._y[rows], steps_np + [0] * pad, w, stale,
                          self.alg.strategy.prox_mu, padded(idx),
                          None if u is None else padded(u))
            self._sync_if_traced()
        return out

    def _codec_roundtrip(self, stacked: torch.Tensor, anchors: torch.Tensor
                         ) -> torch.Tensor:
        """Each client's return re-expressed as anchor + codec.apply(delta)
        — exactly what the server receives after a lossy uplink. A
        stochastic codec's uniforms come from the sampler, right after
        the round's minibatch draw."""
        layout = self.workload.layout
        u = (self.sampler.codec_uniforms(len(stacked), layout)
             if self.codec.stochastic else None)
        decoded = client_roundtrip(self.codec, stacked, anchors, layout, u)
        if obs_enabled():
            count("comms.codec_error",
                  float(torch.linalg.vector_norm(stacked - decoded)))
        return decoded

    def _train_round(self, global_params, ks: list[int], epochs: list[int],
                     *, weights, staleness, anchors=None) -> torch.Tensor:
        """Client updates + aggregation for one round (or buffer flush),
        dispatched on the execution mode. Returns the new global params."""
        if self.execution == "mesh":
            return self._run_clients_mesh(
                global_params, ks, epochs, weights=weights,
                staleness=staleness, anchors=anchors)
        stacked = self._run_clients(global_params, ks, epochs,
                                    anchors=anchors)
        if self.codec.lossy:
            # The server only ever sees the codec round-trip of each
            # client's delta against its anchor.
            stacked = self._codec_roundtrip(
                stacked, global_params if anchors is None else anchors)
        with span("sim.aggregate", strategy=self.alg.strategy.name,
                  clients=len(ks)):
            out = self.alg.strategy.aggregate(
                global_params, stacked,
                torch.as_tensor(weights, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(staleness, device=self.device))
            self._sync_if_traced()
        return out

    def _finish_round(self, rounds: list[RoundRecord], curve: list,
                      global_params, *, t_start: float, t_end: float,
                      participants, epochs, idle_s, compute_s, comm_s,
                      relays, staleness, relay_hops, comms_bytes,
                      do_eval: bool) -> RoundRecord:
        """Construct the RoundRecord, run the eval slot, and append."""
        # Wire savings vs full-precision returns: IEEE-exact 0.0 with no
        # codec (every term is the same sum of model_bytes).
        mb = float(self.hw.model_bytes)
        wire_saved = sum((1.0 + h) * mb + mb - cb
                         for h, cb in zip(relay_hops, comms_bytes))
        if obs_enabled():
            # Encoded uplink bytes actually on the wire this round
            # (billed bytes minus the full-precision download leg).
            count("comms.encoded_bytes", sum(cb - mb for cb in comms_bytes))
        rec = RoundRecord(
            idx=len(rounds), t_start=t_start, t_end=t_end,
            participants=participants, epochs=epochs, idle_s=idle_s,
            compute_s=compute_s, comm_s=comm_s, relays=relays,
            staleness=staleness, relay_hops=relay_hops,
            comms_bytes=comms_bytes, wire_bytes_saved=wire_saved,
            execution=self.execution,
        )
        if self.cfg.record_params and global_params is not None:
            self._params_hist.append(
                params_to_numpy(global_params, self.workload.layout))
        if do_eval:
            # The eval slot exists in the round protocol whether or not
            # this run trains; timing-only runs record it as an empty span.
            with span("sim.eval", round=rec.idx, trained=self.cfg.train):
                if self.cfg.train:
                    rec.accuracy = self._eval(global_params, t_end)
                    curve.append((rec.idx, t_end, rec.accuracy))
                count("sim.evals")
        rounds.append(rec)
        count("sim.rounds")
        return rec

    def _final_eval(self, rounds: list[RoundRecord], curve: list,
                    global_params) -> None:
        """Evaluate the final model when a run exits off-cadence, so
        `curve[-1]` always reflects `final_params`."""
        if not (self.cfg.train and rounds):
            return
        last = rounds[-1]
        if curve and curve[-1][0] == last.idx:
            return  # the cadence already evaluated the final model
        with span("sim.eval", round=last.idx, trained=True,
                  exit_path=True):
            last.accuracy = self._eval(global_params, last.t_end)
            curve.append((last.idx, last.t_end, last.accuracy))
            count("sim.evals")

    def _result(self, rounds: list[RoundRecord], curve: list,
                global_params) -> SimResult:
        final = (params_to_numpy(global_params, self.workload.layout)
                 if (self.cfg.train and global_params is not None) else None)
        return SimResult(self.alg.name, self.constellation.n_sats,
                         len(self.stations), rounds, curve,
                         execution=self.execution,
                         params_history=self._params_hist,
                         final_params=final)

    def _eval(self, global_params, t: float) -> float:
        """Evaluation-stage client selection: same contact protocol.

        The eval batch is padded to the next power-of-two client count
        with zero-weight rows, as in the reference.
        """
        c = min(self.cfg.clients_per_round, self.constellation.n_sats)
        with span("sim.select", stage="eval"):
            plans = self.alg.selector.select(
                self.aw, t, range(self.constellation.n_sats), c,
                self.alg.strategy, self.hw, self.alg.local_epochs,
                self.alg.min_epochs, plan=self.plan)
        ks = [p.k for p in plans] or list(range(min(c, self.data.n_clients)))
        pad = self._bound([len(ks)]) - len(ks)
        ks_p = ks + [ks[0]] * pad
        n_eval = np.asarray(self.data.n_eval[ks_p]).copy()
        if pad:
            n_eval[len(ks):] = 0  # masked out of the weighted accuracy
        rows = torch.as_tensor(ks_p, device=self.device)
        acc = self.workload.eval_fn(
            global_params, self._x_eval[rows], self._y_eval[rows],
            torch.as_tensor(n_eval, device=self.device))
        return float(acc)

    # ------------------------------------------------------------------ #
    # Strategy-driven event loop
    # ------------------------------------------------------------------ #
    def _build_outlook(self) -> ContactOutlook:
        """Read-only contact-schedule view handed to the strategy hooks.

        Built from the compiled ContactPlan when the algorithm plans
        against one, otherwise straight from the access windows at the
        hardware link rate. Only constructed when a hook actually reads
        it (`_LazyOutlook`), so stock strategies pay nothing."""
        if self.plan is not None:
            return ContactOutlook.from_plan(self.plan)
        return ContactOutlook.from_access(
            self.aw, rate_bps=self.hw.link_mbps * 1e6)

    def _sync_flush_groups(self, plans, outlook) -> list[list[int]]:
        """Partition one synchronous selection into aggregation groups.

        Scheduled returns are fed through `admit`/`should_flush` in
        arrival (tx_end) order; each positive flush decision closes a
        group. Group members are emitted in plan (selection) order, so
        aggregation weight order matches the classic barrier bitwise."""
        strategy = self.alg.strategy
        order = sorted(range(len(plans)), key=lambda i: plans[i].tx_end)
        groups: list[list[int]] = []
        pend_idx: list[int] = []
        pend_upd: list[PendingUpdate] = []
        for pos, i in enumerate(order):
            p = plans[i]
            nxt = (plans[order[pos + 1]].tx_end
                   if pos + 1 < len(order) else None)
            upd = PendingUpdate(k=p.k, staleness=0, epochs=p.epochs,
                                tx_end=p.tx_end)
            if not strategy.admit(upd, BufferState(
                    updates=tuple(pend_upd), target_size=len(plans),
                    now=p.tx_end, next_arrival_s=nxt)):
                continue      # rejected sync returns are dropped
            pend_idx.append(i)
            pend_upd.append(upd)
            state = BufferState(updates=tuple(pend_upd),
                                target_size=len(plans), now=p.tx_end,
                                next_arrival_s=nxt)
            if strategy.should_flush(state, outlook):
                groups.append(sorted(pend_idx))
                pend_idx, pend_upd = [], []
        if pend_idx:      # the tail aggregates rather than being dropped
            groups.append(sorted(pend_idx))
        return groups

    def _initial_params(self) -> torch.Tensor:
        """The sampler's init (always drawn, so the random stream is the
        same with or without `init_params`), overridden by `init_params`."""
        params = self.sampler.init(self.workload)
        if self.init_params is not None:
            params = params_from_jax(self.init_params, self.workload.layout,
                                     device=self.device)
        return params

    def _run_events(self) -> SimResult:
        """The unified round loop: one of two event feeds (synchronous
        selection barrier / asynchronous upload heap) routes every
        scheduling decision through the strategy hooks."""
        cfg, alg = self.cfg, self.alg
        global_params = self._initial_params() if cfg.train else None
        outlook = _LazyOutlook(self._build_outlook)
        rounds: list[RoundRecord] = []
        curve: list[tuple[int, float, float]] = []
        if alg.synchronous:
            global_params = self._sync_feed(global_params, outlook,
                                            rounds, curve)
        else:
            global_params = self._async_feed(global_params, outlook,
                                             rounds, curve)
        self._final_eval(rounds, curve, global_params)
        return self._result(rounds, curve, global_params)

    def _sync_feed(self, global_params, outlook, rounds, curve):
        """Synchronous feed (Algorithms 1-2): select, then aggregate each
        flush group the strategy closes over the selection's returns."""
        cfg, hw, alg = self.cfg, self.hw, self.alg
        strategy = alg.strategy
        K = self.constellation.n_sats
        c = min(cfg.clients_per_round, K)

        t = 0.0
        stop = False
        while len(rounds) < cfg.max_rounds and not stop:
            t = max(t, strategy.next_sync_point(outlook, t))
            if t >= cfg.horizon_s:
                break
            with span("sim.round", idx=len(rounds)) as round_span:
                with span("sim.select", stage="train"):
                    plans = alg.selector.select(
                        self.aw, t, range(K), c, strategy, hw,
                        alg.local_epochs, alg.min_epochs, plan=self.plan)
                if not plans:
                    round_span.set(aborted="no_plans")
                    break
                groups = self._sync_flush_groups(plans, outlook)
                if not groups:
                    # Strategy admitted nothing: time cannot advance.
                    round_span.set(aborted="no_admits")
                    break
                t_group = t
                for g in groups:
                    if len(rounds) >= cfg.max_rounds:
                        break
                    sub = [plans[i] for i in g]
                    t_end = max(p.tx_end for p in sub)
                    if t_end > cfg.horizon_s:
                        round_span.set(aborted="horizon")
                        stop = True
                        break
                    if cfg.train:
                        ks = [p.k for p in sub]
                        global_params = self._train_round(
                            global_params, ks, [p.epochs for p in sub],
                            weights=self.data.n[ks].astype(np.float32),
                            staleness=np.zeros((len(sub),), np.int32))
                    self._finish_round(
                        rounds, curve, global_params,
                        do_eval=(len(rounds) % cfg.eval_every == 0
                                 or len(rounds) == cfg.max_rounds - 1),
                        **sync_round_metrics(sub, t_group, t_end),
                    )
                    t_group = t_end
                    t = max(t, t_end)
        return global_params

    def _async_feed(self, global_params, outlook, rounds, curve):
        """Asynchronous feed (Algorithm 3): every satellite cycles
        contact->train->upload; the strategy decides which uploads buffer
        and when the buffer flushes (default: at D updates, FedBuff)."""
        cfg, hw, alg = self.cfg, self.hw, self.alg
        strategy = alg.strategy
        K = self.constellation.n_sats
        c = strategy.round_size(min(cfg.clients_per_round, K))
        D = max(1, int(round(alg.buffer_frac * c)))
        history = {0: global_params}
        version = 0
        last_agg_t = 0.0

        # Event heap of (upload_done_t, sat, version_at_download, epochs,
        # download_t, train_span, comm_s).
        heap: list = []

        def schedule_cycle(k: int, t: float, ver: int):
            w = self.aw.next_window(k, t)
            if w is None:
                return
            rx_end = w[0] + hw.tx_time_s
            # Train across the inter-pass gap; upload at the *next* pass
            # (never the download pass itself).
            nxt = self.aw.next_window(k, w[1] + 1.0)
            if nxt is None:
                return
            epochs = max(1, hw.epochs_between(rx_end, nxt[0]))
            train_span = nxt[0] - rx_end   # continuous on-board training
            tx_end = nxt[0] + hw.ul_time_s
            heapq.heappush(heap, (tx_end, k, ver, epochs, w[0], train_span,
                                  hw.tx_time_s + hw.ul_time_s))

        for k in range(K):
            schedule_cycle(k, 0.0, 0)

        buffer: list = []
        pending: list[PendingUpdate] = []   # strategy-facing twin of buffer
        while heap and len(rounds) < cfg.max_rounds:
            tx_end, k, ver, epochs, dl_t, train_span, comm_s = heapq.heappop(heap)
            if tx_end > cfg.horizon_s:
                break
            nxt_arrival = heap[0][0] if heap else None
            upd = PendingUpdate(k=k, staleness=version - ver, epochs=epochs,
                                tx_end=tx_end, version=ver)
            if strategy.admit(upd, BufferState(
                    updates=tuple(pending), target_size=D, now=tx_end,
                    version=version, next_arrival_s=nxt_arrival)):
                buffer.append((k, ver, epochs, dl_t, train_span, comm_s,
                               tx_end))
                pending.append(upd)

            state = BufferState(updates=tuple(pending), target_size=D,
                                now=tx_end, version=version,
                                next_arrival_s=nxt_arrival)
            if not buffer or not strategy.should_flush(state, outlook):
                # Satellite immediately re-downloads in the same pass and
                # keeps training — FedBuff's no-idle property.
                schedule_cycle(k, tx_end, version)
                continue

            # --- aggregate the buffer ---------------------------------- #
            with span("sim.round", idx=len(rounds), mode="async",
                      flush=len(buffer)):
                t_agg = tx_end
                staleness = np.array([version - b[1] for b in buffer],
                                     np.int32)
                ns = np.array([float(self.data.n[b[0]]) if cfg.train else 1.0
                               for b in buffer], np.float32)
                weights = buffer_weights(ns, staleness,
                                         alg.strategy.max_staleness)
                if cfg.train:
                    ks = [b[0] for b in buffer]
                    anchors = torch.stack([history[b[1]] for b in buffer])
                    global_params = self._train_round(
                        global_params, ks, [b[2] for b in buffer],
                        weights=weights, staleness=staleness,
                        anchors=anchors)
                version += 1
                history[version] = global_params
                # The buffer-filling satellite re-downloads the *new* model.
                schedule_cycle(k, tx_end, version)
                # Prune history entries no in-flight client still anchors on.
                prune_history(history, (e[2] for e in heap), version)

                self._finish_round(
                    rounds, curve, global_params,
                    t_start=last_agg_t, t_end=t_agg,
                    participants=[b[0] for b in buffer],
                    epochs=[b[2] for b in buffer],
                    # Async clients only idle while a pass is out of reach
                    # after the duty-cycle cap ends.
                    idle_s=[max(0.0, (b[6] - b[3]) - b[4] - b[5])
                            for b in buffer],
                    compute_s=[b[4] for b in buffer],
                    comm_s=[b[5] for b in buffer],
                    relays=[-1] * len(buffer),
                    staleness=staleness.tolist(),
                    relay_hops=[0] * len(buffer),
                    comms_bytes=[hw.round_trip_bytes] * len(buffer),
                    do_eval=(len(rounds) % cfg.eval_every == 0),
                )
                last_agg_t = t_agg
                buffer = []
                pending = []
        return global_params


class _LazyOutlook:
    """Deferred `ContactOutlook` construction for the strategy hooks: the
    stock strategies never read it, so it is only built on first
    attribute access."""

    def __init__(self, build):
        self._build = build
        self._view = None

    def __getattr__(self, name):
        if self._view is None:
            self._view = self._build()
        return getattr(self._view, name)
