from repro_torch.sim.engine import ConstellationSim, SimConfig, TorchSampler
from repro_torch.sim.metrics import RoundRecord, SimResult

__all__ = ["ConstellationSim", "SimConfig", "TorchSampler", "RoundRecord",
           "SimResult"]
