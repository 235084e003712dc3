from repro_torch.data.federated import FederatedDataset
from repro_torch.data.femnist import synth_femnist

__all__ = ["FederatedDataset", "synth_femnist"]
