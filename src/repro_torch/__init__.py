"""repro_torch — the PyTorch + CUDA port of `repro`.

Mirrors `repro/`'s module paths and public names, one file per reference
file, so each module has exactly one counterpart to be checked against.
It imports torch, numpy and the standard library only: never `jax`, and
nothing of `repro` (pure-Python helpers are copied, not shared).

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`repro_torch.device.resolve_device`). The kernels — the simulator's
`prox_sgd` and `fedagg`, the LM prefill's `flash_attention` and `wkv6` —
are hand-written CUDA C++ for Hopper (`repro_torch/csrc/`); CPU tensors
take their plain PyTorch versions (`repro_torch.kernels.ref`).
"""
import torch

# The parity tolerances against the JAX reference (1e-5 on params and
# accuracy curves, 2e-5 on the f32 kernels) are float32's. TF32 keeps ~3
# decimal digits, so both matmul and cuDNN TF32 are pinned off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
