from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.optim.sgd import momentum_init, momentum_update, sgd_update

__all__ = ["adam_init", "adam_update", "sgd_update", "momentum_init",
           "momentum_update"]
