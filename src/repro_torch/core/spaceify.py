"""spaceify(): compose a terrestrial strategy with orbital selection.

Port of `repro.core.spaceify`. A `SpaceifiedAlgorithm` bundles
  strategy  (aggregation math + client regime + scheduling hooks)
  selector  (training-stage AND evaluation-stage client selection)
  knobs     (local epochs E, min-epoch floor, buffer size D)
and is what `repro_torch.sim.engine.ConstellationSim` executes.

`ALGORITHMS` is an open registry whose built-in suite is the paper's
Table-1 variants (8). The reference's ISL extensions (`*_isl`), the
connectivity-aware strategies (`fedspace`, `ground_assisted`,
`fedprox_sparse`) and lossy uplink codecs come with the comms slice
(ROADMAP): asking for them raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

from repro_torch.core.selection import (
    BaseSelector,
    IntraCCSelector,
    ScheduleSelector,
)
from repro_torch.core.strategies.base import Strategy
from repro_torch.core.strategies.fedavg import FedAvgSat
from repro_torch.core.strategies.fedbuff import FedBuffSat
from repro_torch.core.strategies.fedprox import FedProxSat

# Reference registry entries that need the comms slice.
_COMMS_SLICE_NAMES = ("fedavg_intracc_isl", "fedprox_intracc_isl",
                      "fedspace", "ground_assisted", "fedprox_sparse")


@dataclasses.dataclass(frozen=True)
class SpaceifiedAlgorithm:
    name: str
    strategy: Strategy
    selector: BaseSelector
    local_epochs: int = 5      # E (FIXED_EPOCHS regime)
    min_epochs: int = 0        # SchedV2 floor (UNTIL_CONTACT regime)
    buffer_frac: float = 1.0   # FedBuff: D = max(1, round(buffer_frac * c))
    isl: bool = False          # plan against an ISL-aware ContactPlan
    codec: str = "identity"    # uplink transfer codec

    def __post_init__(self):
        # Knob validation at construction: a bad knob otherwise surfaces
        # rounds deep in a sweep as a shape error or an empty buffer.
        if self.codec != "identity":
            raise NotImplementedError(
                f"algorithm {self.name!r}: uplink codec {self.codec!r}: "
                "ROADMAP comms slice")
        if self.isl:
            raise NotImplementedError(
                f"algorithm {self.name!r}: ISL relays: ROADMAP comms slice")
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
    """Adapt any terrestrial `Strategy` for orbital deployment."""
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


# The paper-exact Table-1 names, pinned explicitly so growing the registry
# never leaks into the paper-reproduction subset.
TABLE1_NAMES = ("fedavg", "fedavg_sched", "fedavg_intracc",
                "fedprox", "fedprox_sched", "fedprox_sched_v2",
                "fedprox_intracc", "fedbuff")


def _builtin_suite() -> list[SpaceifiedAlgorithm]:
    """The Table-1 suite."""
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
    ]


class AlgorithmRegistry(Mapping):
    """Open, lazily-built name -> `SpaceifiedAlgorithm` registry.

    Reads like a plain dict; lookups of unknown names raise a KeyError
    that lists the sorted registered keys, and lookups of reference
    entries that need the comms slice raise NotImplementedError.
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
        if name in _COMMS_SLICE_NAMES:
            raise NotImplementedError(
                f"algorithm {name!r}: ROADMAP comms slice")
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
