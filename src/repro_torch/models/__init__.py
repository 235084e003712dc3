from repro_torch.models.femnist_cnn import femnist_cnn_apply, femnist_cnn_init
from repro_torch.models.femnist_mlp import femnist_mlp_apply, femnist_mlp_init

__all__ = ["femnist_cnn_apply", "femnist_cnn_init", "femnist_mlp_apply",
           "femnist_mlp_init"]
