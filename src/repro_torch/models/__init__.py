from repro_torch.models.femnist_mlp import femnist_mlp_apply, femnist_mlp_init

__all__ = ["femnist_mlp_apply", "femnist_mlp_init"]
