"""Device resolution for every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`cuda:0` unless the caller asks for something else.

    Raises when CUDA is requested (explicitly or by default) but absent:
    the port never carries on quietly on the CPU. `"cpu"` runs the plain
    PyTorch versions of the kernels (the tests use it). `"meta"` runs
    them on shapes alone, allocating and computing nothing: the dry run's
    counterpart of `jax.eval_shape` (`repro_torch.launch.dryrun`).
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or "
                         "meta")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
