"""LM weights carried across the two packages.

The reference's `init_params` tree (nested dicts and the `"segments"`
list, numpy leaves after `jax.device_get`) maps leaf for leaf onto the
port's tree: same names, shapes and dtypes. bfloat16 leaves travel as
their 16-bit patterns, so neither side needs the other's bf16 type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.params import leaves_with_paths


def map_tree(fn, tree, *rest):
    """`fn` over the leaves of an LM param or cache tree (dicts and the
    `"segments"` list), keeping its structure; with more trees of the same
    structure, `fn` takes their leaves side by side."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in `jax.tree.leaves` order: dict keys sorted, lists by
    index."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:       # numpy knows "bfloat16" once ml_dtypes (jax's) is loaded
        bf16 = np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError("bfloat16 leaves need numpy's bfloat16 dtype "
                        "(registered by ml_dtypes)") from e
    return t.view(torch.int16).numpy().view(bf16).copy()


def lm_params_from_jax(tree: dict, device=None) -> dict:
    """Reference LM params (numpy leaves) -> the port's tensors on
    `device` (CUDA unless asked otherwise)."""
    device = resolve_device(device)
    return map_tree(lambda a: _to_tensor(a, device), tree)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM params -> numpy leaves with the reference's names,
    shapes and dtypes (what `jax.device_get` of its tree gives)."""
    return map_tree(_to_numpy, params)
