"""The space-ification framework (port of `repro.core`).

`repro_torch.core` turns a terrestrial FL strategy into an orbital one by
composing a `Strategy` (FedAvgSat / FedProxSat / FedBuffSat / the
connectivity-aware extensions: aggregation math, client regime,
scheduling hooks), a `Selector` (orbital client selection over access
windows or a `ContactPlan`) and the round-completion semantics the
engine's event loop dispatches through the strategy's hooks.
"""
from repro_torch.core.strategies.base import (
    BufferState,
    ClientWorkMode,
    PendingUpdate,
    Strategy,
)
from repro_torch.core.strategies.fedavg import FedAvgSat
from repro_torch.core.strategies.fedprox import FedProxSat
from repro_torch.core.strategies.fedbuff import FedBuffSat
from repro_torch.core.strategies.fedspace import FedSpaceSat
from repro_torch.core.strategies.ground_assisted import GroundAssistedSat
from repro_torch.core.strategies.sparse import sparse_variant
from repro_torch.core.selection import (
    BaseSelector,
    ScheduleSelector,
    IntraCCSelector,
    ClientPlan,
)
from repro_torch.core.spaceify import (
    ALGORITHMS,
    TABLE1_ALGORITHMS,
    TABLE1_NAMES,
    SpaceifiedAlgorithm,
    algorithm_names,
    get_algorithm,
    register_algorithm,
    spaceify,
)
from repro_torch.core.workload import (
    Workload,
    get_workload,
    lm_workload,
    make_lm_evaluate,
    register_workload,
    validate_execution,
    workload_names,
)

__all__ = [
    "Strategy",
    "ClientWorkMode",
    "BufferState",
    "PendingUpdate",
    "FedAvgSat",
    "FedProxSat",
    "FedBuffSat",
    "FedSpaceSat",
    "GroundAssistedSat",
    "sparse_variant",
    "BaseSelector",
    "ScheduleSelector",
    "IntraCCSelector",
    "ClientPlan",
    "SpaceifiedAlgorithm",
    "spaceify",
    "ALGORITHMS",
    "TABLE1_ALGORITHMS",
    "TABLE1_NAMES",
    "algorithm_names",
    "get_algorithm",
    "register_algorithm",
    "Workload",
    "get_workload",
    "lm_workload",
    "make_lm_evaluate",
    "register_workload",
    "validate_execution",
    "workload_names",
]
