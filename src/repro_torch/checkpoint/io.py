"""Checkpointing: a param tree <-> npz with a JSON sidecar.

Port of `repro.checkpoint.io`, file for file: arrays are stored flat in
`<path>.npz`, keyed by their tree path ("segments/0/attn/wq"; dict keys
and list indices joined with "/"); bfloat16 leaves as their uint16 bit
patterns, with "__bf16__" appended to their name in the sidecar's
`keys`. The sidecar `<path>.json` holds the tree's structure in the
reference's notation (`treedef`), `keys` and `step`. The reference
restores the port's files and the port the reference's: restoring reads
the npz by path and takes the structure, dtypes and device from `like`.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.params import leaves_with_paths

_BF16_TAG = "__bf16__"


def _treedef(tree) -> str:
    """The structure as `str(jax.tree.structure(tree))` spells it."""
    def spell(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {spell(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "[" + ", ".join(spell(v) for v in t) + "]"
        return "*"
    return f"PyTreeDef({spell(tree)})"


def save_checkpoint(path: str, tree, step: int | None = None) -> None:
    """Write `tree` (tensors or arrays) to `<path>.npz` + `<path>.json`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, keys = {}, []
    for key, leaf in leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
                keys.append(key + _BF16_TAG)
                continue
            leaf = t.numpy()
        arrays[key] = np.asarray(leaf)
        keys.append(key)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"treedef": _treedef(tree), "keys": keys, "step": step}, f)


def restore_checkpoint(path: str, like):
    """Restore into the structure of `like` (a tree of tensors whose
    shapes match): each leaf takes `like`'s dtype and device."""
    data = np.load(path + ".npz")

    def restore(t, prefix):
        if isinstance(t, dict):
            return {k: restore(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [restore(v, f"{prefix}{i}/") for i, v in enumerate(t)]
        arr = data[prefix[:-1]]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {prefix[:-1]}: shape "
                             f"{arr.shape}, expected {tuple(t.shape)}")
        if t.dtype == torch.bfloat16:
            out = torch.from_numpy(arr.astype(np.uint16).view(np.int16)
                                   ).view(torch.bfloat16)
        else:
            out = torch.as_tensor(arr).to(t.dtype)
        return out.to(t.device)

    return restore(like, "")
