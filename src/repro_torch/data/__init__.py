from repro_torch.data.federated import FederatedDataset
from repro_torch.data.femnist import synth_femnist
from repro_torch.data.tokens import (
    federated_token_shards,
    synthetic_token_batch,
)

__all__ = ["FederatedDataset", "synth_femnist", "synthetic_token_batch",
           "federated_token_shards"]
