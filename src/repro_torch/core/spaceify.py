"""spaceify(): compose a terrestrial strategy with orbital selection.

Port of `repro.core.spaceify`. A `SpaceifiedAlgorithm` bundles
  strategy  (aggregation math + client regime + scheduling hooks)
  selector  (training-stage AND evaluation-stage client selection)
  knobs     (local epochs E, min-epoch floor, buffer size D)
and is what `repro_torch.sim.engine.ConstellationSim` executes.

`ALGORITHMS` is an open registry. The built-in suite — the paper's
Table-1 variants (8), the ISL-enabled extensions (`*_isl`) and the
connectivity-aware strategies (`fedspace`, `ground_assisted`,
`fedprox_sparse`) — is the reference's, built on first lookup.

`isl=True` marks an algorithm as planning against a
`repro_torch.comms.ContactPlan`, so relayed parameter returns are routed
store-and-forward over inter-satellite links; `codec=` names the uplink
transfer codec (`repro_torch.comms.codec`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

from repro_torch.comms.codec import get_codec
from repro_torch.core.selection import (
    BaseSelector,
    IntraCCSelector,
    ScheduleSelector,
)
from repro_torch.core.strategies.base import Strategy
from repro_torch.core.strategies.fedavg import FedAvgSat
from repro_torch.core.strategies.fedbuff import FedBuffSat
from repro_torch.core.strategies.fedprox import FedProxSat
from repro_torch.core.strategies.fedspace import FedSpaceSat
from repro_torch.core.strategies.ground_assisted import GroundAssistedSat
from repro_torch.core.strategies.sparse import sparse_variant


@dataclasses.dataclass(frozen=True)
class SpaceifiedAlgorithm:
    name: str
    strategy: Strategy
    selector: BaseSelector
    local_epochs: int = 5      # E (FIXED_EPOCHS regime)
    min_epochs: int = 0        # SchedV2 floor (UNTIL_CONTACT regime)
    buffer_frac: float = 1.0   # FedBuff: D = max(1, round(buffer_frac * c))
    isl: bool = False          # plan against an ISL-aware ContactPlan
    # Uplink transfer codec (`repro_torch.comms.codec` registry name):
    # "identity" keeps the full-precision symmetric pricing bitwise;
    # lossy codecs compress the client's return on the wire AND on the
    # training path (the engine applies the lossy delta).
    codec: str = "identity"

    def __post_init__(self):
        # Knob validation at construction: a bad knob otherwise surfaces
        # rounds deep in a sweep as a shape error or an empty buffer.
        get_codec(self.codec)   # unknown codec: KeyError w/ vocabulary
        if not 0.0 < self.buffer_frac <= 1.0:
            raise ValueError(
                f"algorithm {self.name!r}: buffer_frac must be in (0, 1], "
                f"got {self.buffer_frac}")
        if self.min_epochs < 0:
            raise ValueError(
                f"algorithm {self.name!r}: min_epochs must be >= 0, "
                f"got {self.min_epochs}")
        if self.local_epochs < 1:
            raise ValueError(
                f"algorithm {self.name!r}: local_epochs must be >= 1, "
                f"got {self.local_epochs}")
        if not self.strategy.synchronous and self.strategy.max_staleness < 0:
            raise ValueError(
                f"algorithm {self.name!r}: async strategy "
                f"{self.strategy.name!r} needs max_staleness >= 0, "
                f"got {self.strategy.max_staleness}")

    @property
    def synchronous(self) -> bool:
        return self.strategy.synchronous


def spaceify(strategy: Strategy, *, schedule: bool = False,
             intracc: bool = False, isl: bool = False, min_epochs: int = 0,
             local_epochs: int = 5, name: str | None = None,
             buffer_frac: float = 1.0,
             max_hops: int = 3,
             codec: str = "identity") -> SpaceifiedAlgorithm:
    """Adapt any terrestrial `Strategy` for orbital deployment.

    `isl=True` makes the simulator compile a `ContactPlan` (ground passes
    + ISL contact windows) and plan itineraries against it: transfer
    times follow per-window achievable rates and relays become real
    (bounded at `max_hops` store-and-forward legs). `codec` names a
    `repro_torch.comms.codec` registry entry pricing (and, for lossy
    codecs, transforming) the client's uplink; non-identity codecs suffix
    the derived name (`fedavg_quant_int8`).
    """
    if intracc:
        selector = IntraCCSelector(schedule=schedule, max_hops=max_hops)
    elif schedule:
        selector = ScheduleSelector(max_hops=max_hops)
    else:
        selector = BaseSelector(max_hops=max_hops)
    suffix = ("_sched" if schedule else "") + ("_intracc" if intracc else "")
    if min_epochs:
        suffix += "_v2"
    if isl:
        suffix += "_isl"
    if codec != "identity":
        suffix += f"_{codec}"
    return SpaceifiedAlgorithm(
        name=name or strategy.name + suffix,
        strategy=strategy,
        selector=selector,
        local_epochs=local_epochs,
        min_epochs=min_epochs,
        buffer_frac=buffer_frac,
        isl=isl,
        codec=codec,
    )


# The paper-exact Table-1 names (no ISL extensions, no related-work
# strategies), pinned explicitly so growing the registry never leaks into
# the paper-reproduction subset.
TABLE1_NAMES = ("fedavg", "fedavg_sched", "fedavg_intracc",
                "fedprox", "fedprox_sched", "fedprox_sched_v2",
                "fedprox_intracc", "fedbuff")


def _builtin_suite() -> list[SpaceifiedAlgorithm]:
    """Table-1 suite + ISL extensions + connectivity-aware strategies."""
    fedavg, fedprox, fedbuff = FedAvgSat(), FedProxSat(), FedBuffSat()
    return [
        spaceify(fedavg),
        spaceify(fedavg, schedule=True),
        spaceify(fedavg, intracc=True),
        spaceify(fedprox),
        spaceify(fedprox, schedule=True),
        spaceify(fedprox, schedule=True, min_epochs=5),   # FedProxSchedV2
        spaceify(fedprox, intracc=True),
        spaceify(fedbuff),
        # ISL extensions: the relay hand-off priced by the comms layer.
        spaceify(fedavg, intracc=True, isl=True),
        spaceify(fedprox, intracc=True, isl=True),
        # Connectivity-aware strategies: schedule-aware flush timing,
        # per-visit ground aggregation, and a half-participation variant.
        spaceify(FedSpaceSat(), buffer_frac=0.5),
        spaceify(GroundAssistedSat()),
        spaceify(sparse_variant(FedProxSat(), 0.5)),
    ]


class AlgorithmRegistry(Mapping):
    """Open, lazily-built name -> `SpaceifiedAlgorithm` registry.

    Reads like a plain dict; lookups of unknown names raise a KeyError
    that lists the sorted registered keys.
    """

    def __init__(self, factory):
        self._factory = factory
        self._algs: dict[str, SpaceifiedAlgorithm] | None = None

    def _ensure(self) -> dict[str, SpaceifiedAlgorithm]:
        if self._algs is None:
            self._algs = {}
            for alg in self._factory():
                self.register(alg)
        return self._algs

    def register(self, alg: SpaceifiedAlgorithm, *,
                 overwrite: bool = False) -> SpaceifiedAlgorithm:
        algs = self._ensure()
        if alg.name in algs and not overwrite:
            raise ValueError(
                f"algorithm {alg.name!r} is already registered; pass "
                "overwrite=True to replace it")
        algs[alg.name] = alg
        return alg

    def __getitem__(self, name: str) -> SpaceifiedAlgorithm:
        algs = self._ensure()
        if name in algs:
            return algs[name]
        raise KeyError(
            f"unknown algorithm {name!r}; registered algorithms: "
            f"{sorted(algs)}")

    def __iter__(self) -> Iterator[str]:
        return iter(self._ensure())

    def __len__(self) -> int:
        return len(self._ensure())


ALGORITHMS = AlgorithmRegistry(_builtin_suite)


def register_algorithm(alg: SpaceifiedAlgorithm, *,
                       overwrite: bool = False) -> SpaceifiedAlgorithm:
    """Add `alg` to the open registry (duplicate names refused unless
    `overwrite=True`). Returns `alg` so registration can inline."""
    return ALGORITHMS.register(alg, overwrite=overwrite)


def get_algorithm(name: str) -> SpaceifiedAlgorithm:
    """Resolve a registry name; unknown names raise a KeyError listing
    the sorted registered keys."""
    return ALGORITHMS[name]


def algorithm_names() -> list[str]:
    """Sorted names of every registered algorithm."""
    return sorted(ALGORITHMS)


class _Table1View(Mapping):
    """Lazy paper-exact subset of `ALGORITHMS` (by pinned name)."""

    def __getitem__(self, name: str) -> SpaceifiedAlgorithm:
        if name not in TABLE1_NAMES:
            raise KeyError(name)
        return ALGORITHMS[name]

    def __iter__(self) -> Iterator[str]:
        return iter(TABLE1_NAMES)

    def __len__(self) -> int:
        return len(TABLE1_NAMES)


TABLE1_ALGORITHMS: Mapping = _Table1View()
