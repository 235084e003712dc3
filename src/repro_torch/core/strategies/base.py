"""Strategy protocol shared by all space-ified FL algorithms.

A `Strategy` owns three things:
  * the *client-update regime* — whether a satellite trains for a fixed
    number of epochs (FedAvg) or keeps training until its next ground
    contact (FedProx / FedBuff), and whether a proximal term anchors the
    local model to the round's global model;
  * the *server aggregation rule* — how returned parameters are folded
    into the global model (sync weighted average, or buffered async with
    staleness discounting);
  * the *round schedule* — when the server admits an arriving update,
    when it flushes the buffered set into an aggregation, and where the
    next round's clock starts. The engine's event loop dispatches every
    one of these decisions through the scheduling hooks below, so a
    strategy can time its aggregations against the known contact
    schedule (a read-only `ContactOutlook` over the plan's window
    tables) instead of inheriting the engine's hardcoded barrier/buffer
    semantics.

Port of `repro.core.strategies.base`. Parameters are flat tensors: the
global model (P,) and the returned client stack (K, P); aggregation goes
through the port's `fedagg` kernel. The scheduling hooks are host-side planning (pure Python over floats) —
they decide *when* tensor math runs, never what it computes.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.core.aggregation import weighted_average


class ClientWorkMode(enum.Enum):
    FIXED_EPOCHS = "fixed_epochs"     # exactly E local epochs, then wait
    UNTIL_CONTACT = "until_contact"   # train until next ground-station pass


@dataclasses.dataclass(frozen=True)
class PendingUpdate:
    """One buffered client return awaiting aggregation.

    `staleness` is the global-version lag at arrival (always 0 for
    synchronous rounds — the barrier admits no stale returns);
    `tx_end` the instant the server received the upload.
    """

    k: int
    staleness: int
    epochs: int
    tx_end: float
    version: int = 0     # global version the client downloaded


@dataclasses.dataclass(frozen=True)
class BufferState:
    """Read-only snapshot of the server's aggregation buffer, handed to
    `Strategy.admit` / `Strategy.should_flush` at every arrival.

    `target_size` is the engine-computed nominal flush size (the sync
    round's selection size, or FedBuff's D); `next_arrival_s` the
    completion time of the next in-flight upload (None when nothing
    more is scheduled to arrive), which is what schedule-aware
    strategies weigh against holding the buffer open.
    """

    updates: tuple[PendingUpdate, ...]
    target_size: int
    now: float
    version: int = 0
    next_arrival_s: float | None = None

    @property
    def fill(self) -> float:
        """Buffer occupancy as a fraction of the nominal flush size."""
        return len(self.updates) / max(self.target_size, 1)

    @property
    def oldest_wait_s(self) -> float:
        """How long the earliest buffered update has been waiting."""
        return self.now - min((u.tx_end for u in self.updates),
                              default=self.now)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Base class; concrete algorithms override `aggregate` and/or the
    scheduling hooks (`admit` / `should_flush` / `next_sync_point`)."""

    name: str = "base"
    work_mode: ClientWorkMode = ClientWorkMode.FIXED_EPOCHS
    synchronous: bool = True
    # Proximal coefficient (FedProx / FedBuff client regularisation).
    prox_mu: float = 0.0
    # Async-only knobs (FedBuff).
    max_staleness: int = 0
    server_lr: float = 1.0
    # Fraction of the nominal selection size that actually participates
    # (sparse-participation edge variants, arXiv 2401.15541 style).
    participation: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")

    # --- server side -----------------------------------------------------
    def aggregate(
        self,
        global_params: torch.Tensor,   # (P,) flat global model
        client_params: torch.Tensor,   # (K, P) stacked client returns
        weights: torch.Tensor,         # (K,) n_k sample counts (masked)
        staleness: torch.Tensor,       # (K,) integer rounds behind; sync: 0
    ) -> torch.Tensor:
        """Fold returned client parameters into the global model (Eq. 1)."""
        del global_params, staleness
        return weighted_average(client_params, weights)

    # --- scheduling hooks (the engine's event loop dispatches here) ------
    def admit(self, update: PendingUpdate, state: BufferState) -> bool:
        """Whether an arriving update enters the aggregation buffer.

        `state` is the buffer *before* this update. The default admits
        everything — staleness is handled by aggregation weights
        (`buffer_weights` zeroes over-stale updates), matching the
        paper's FedBuff semantics.
        """
        del update, state
        return True

    def should_flush(self, state: BufferState, outlook) -> bool:
        """Whether the server aggregates the buffered set *now*.

        Called after each admitted arrival with the post-admission
        `state` and the contact `outlook`
        (`repro_torch.comms.contact_plan.ContactOutlook`). The default is
        the size barrier both stock loops used: flush exactly when the
        buffer reaches its nominal size (the sync round's full
        selection, FedBuff's D).
        """
        del outlook
        return len(state.updates) >= state.target_size

    def next_sync_point(self, outlook, t: float) -> float:
        """Where the next synchronous round's clock starts.

        The default keeps the barrier semantics: the next round begins
        the instant the previous one ended. Schedule-aware strategies
        may jump ahead (e.g. to the next ground pass) so reported idle
        time reflects their round anchoring; the engine never lets the
        clock move backwards.
        """
        del outlook
        return t

    def round_size(self, c: int) -> int:
        """Participants actually selected out of a nominal budget `c`."""
        if self.participation >= 1.0:
            return c
        return max(1, int(round(self.participation * c)))

    # --- bookkeeping ------------------------------------------------------
    def staleness_ok(self, staleness: int) -> bool:
        """Bounded-staleness admission check (async algorithms)."""
        if self.synchronous:
            return staleness == 0
        return staleness <= self.max_staleness
