from repro_torch.sim.batched import BatchedSweep, run_batched
from repro_torch.sim.engine import ConstellationSim, SimConfig, TorchSampler
from repro_torch.sim.metrics import RoundRecord, SimResult

__all__ = ["BatchedSweep", "ConstellationSim", "SimConfig", "TorchSampler",
           "RoundRecord", "SimResult", "run_batched"]
