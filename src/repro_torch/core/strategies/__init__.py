from repro_torch.core.strategies.base import (
    BufferState,
    ClientWorkMode,
    PendingUpdate,
    Strategy,
)
from repro_torch.core.strategies.fedavg import FedAvgSat
from repro_torch.core.strategies.fedprox import FedProxSat
from repro_torch.core.strategies.fedbuff import FedBuffSat

# FedSpaceSat, GroundAssistedSat and sparse_variant come with the comms
# slice (ROADMAP).
__all__ = ["Strategy", "ClientWorkMode", "BufferState", "PendingUpdate",
           "FedAvgSat", "FedProxSat", "FedBuffSat"]
