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

__all__ = ["Strategy", "ClientWorkMode", "BufferState", "PendingUpdate",
           "FedAvgSat", "FedProxSat", "FedBuffSat", "FedSpaceSat",
           "GroundAssistedSat", "sparse_variant"]
