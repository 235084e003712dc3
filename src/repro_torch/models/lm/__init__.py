from repro_torch.models.lm.config import (
    EncoderConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    Segment,
    SSMConfig,
)
from repro_torch.models.lm.params import lm_params_from_jax, lm_params_to_numpy
from repro_torch.models.lm.transformer import (
    count_params,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "Segment",
    "EncoderConfig", "init_params", "forward_train", "prefill",
    "decode_step", "init_decode_cache", "count_params",
    "lm_params_from_jax", "lm_params_to_numpy",
]
