"""The current CUDA stream's handle, which every kernel wrapper passes to
its launch."""
from __future__ import annotations

import torch


def current_stream(index: int) -> int:
    """The handle of PyTorch's current CUDA stream on device `index`: what
    `torch.cuda.current_stream(index).cuda_stream` gives, read through
    PyTorch's private `torch._C._cuda_getCurrentRawStream` so that no
    Stream object is built on every launch."""
    return torch._C._cuda_getCurrentRawStream(index)
