"""Flat parameter layout: one contiguous float32 buffer per trained model.

The reference carries parameters as nested dicts (pytrees). The port keeps
a model it trains in one contiguous `(P,)` buffer — or `(C, P)` for a
stack of clients — so a kernel sees a whole model (or a whole round's
client stack) as one array: one `prox_sgd` launch per local step and
one `fedagg` launch per aggregation, with no concatenation copy. Named
per-leaf views are laid out in `jax.tree.leaves` order (sorted dict
keys, lists by index), which is also the order the reference's kernel
wrappers flatten in. A list in the
tree (the LM's `"segments"`) has its index as a path part ("segments/0/
attn/wq"); `views` turns those parts back into a list, ordered by index
as a number, never as a string (so "10" comes after "2").

`params_from_jax` / `params_to_numpy` carry weights across the two
packages as nested dicts of numpy arrays with the reference's leaf names
and shapes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Leaf paths ("fc1/w") and shapes, in flattening order."""

    leaves: tuple[tuple[str, tuple[int, ...]], ...]

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(math.prod(shape) for _, shape in self.leaves)

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @classmethod
    def of_tree(cls, tree) -> "ParamLayout":
        """The layout of a tree of arrays or tensors (dicts and lists),
        leaves in `jax.tree.leaves` order. Only shapes are read, so a
        tree of any dtype, on any device (`meta` included), has one; its
        `size` is the parameter count, whatever the width."""
        return cls(tuple((path, tuple(leaf.shape))
                         for path, leaf in leaves_with_paths(tree)))

    def pack(self, tree) -> torch.Tensor:
        """Flatten a tree of tensors (with an optional shared leading
        client axis), of any float dtype, into one contiguous float32
        buffer on their device (the training stack's width)."""
        parts = []
        for path, shape in self.leaves:
            leaf = _lookup(tree, path)
            lead = leaf.shape[:leaf.dim() - len(shape)]
            parts.append(leaf.float().reshape(lead + (-1,)))
        return torch.cat(parts, dim=-1).contiguous()

    def views(self, flat: torch.Tensor) -> dict:
        """Nested dict (with lists where the tree had them) of views into
        `flat` ((P,) or (C, P)); each view keeps any leading client axis.
        No copy: writes go to `flat`."""
        if flat.shape[-1] != self.size:
            raise ValueError(f"flat params have {flat.shape[-1]} entries, "
                             f"layout expects {self.size}")
        out: dict = {}
        for (path, shape), piece in zip(
                self.leaves, torch.split(flat, self.sizes, dim=-1)):
            *parents, name = path.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = piece.unflatten(-1, shape)
        return _listify(out)

    def from_tree(self, tree: dict, device=None) -> torch.Tensor:
        """Flatten a nested dict of arrays (optionally with a shared
        leading client axis), of any float dtype, into one contiguous
        float32 buffer on `device` (CUDA unless asked otherwise)."""
        device = resolve_device(device)
        parts = []
        for path, shape in self.leaves:
            arr = np.asarray(_lookup(tree, path), dtype=np.float32)
            lead = arr.shape[:arr.ndim - len(shape)]
            if arr.shape[arr.ndim - len(shape):] != tuple(shape):
                raise ValueError(f"leaf {path}: shape {arr.shape} does not "
                                 f"end in {shape}")
            parts.append(arr.reshape(lead + (-1,)))
        flat = np.concatenate(parts, axis=-1)
        return torch.as_tensor(flat, device=device).contiguous()

    def to_tree(self, flat: torch.Tensor) -> dict:
        """Nested dict of numpy arrays (host copies) from a flat buffer."""
        host = flat.detach().cpu()
        views = self.views(host)
        return _map_tree(lambda v: v.numpy().copy(), views)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def leaves_with_paths(tree, prefix: str = ""):
    """(path, leaf) in `jax.tree.leaves` order: dict keys sorted, lists by
    index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def unflatten_like(tree, leaves):
    """A tree shaped like `tree` (its dicts and lists) whose leaves are
    `leaves`, given in `leaves_with_paths` order."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            new = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(tree)


def _lookup(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) \
            else tree[part]
    return tree


def _listify(tree):
    """Dicts whose keys are all list indices ("0", "1", ...) become lists
    in index order."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


# 784 -> 56 -> 47 MLP (`repro.models.femnist_mlp`): P = 46,639.
FEMNIST_MLP = ParamLayout((
    ("fc1/b", (56,)),
    ("fc1/w", (784, 56)),
    ("fc2/b", (47,)),
    ("fc2/w", (56, 47)),
))

# The paper's CNN (`repro.models.femnist_cnn`): conv 1->8 and 8->16 (3x3,
# HWIO kernels), dense 784 -> 56 -> 47; P = 47,887.
FEMNIST_CNN = ParamLayout((
    ("conv1/b", (8,)),
    ("conv1/w", (3, 3, 1, 8)),
    ("conv2/b", (16,)),
    ("conv2/w", (3, 3, 8, 16)),
    ("fc1/b", (56,)),
    ("fc1/w", (784, 56)),
    ("fc2/b", (47,)),
    ("fc2/w", (56, 47)),
))


def params_from_jax(tree: dict, layout: ParamLayout = FEMNIST_MLP,
                    device=None) -> torch.Tensor:
    """Reference params (nested dict of numpy arrays, e.g. from
    `jax.device_get`) -> flat float32 tensor, (P,) or (C, P), on `device`
    (CUDA unless asked otherwise)."""
    return layout.from_tree(tree, device=device)


def params_to_numpy(flat: torch.Tensor,
                    layout: ParamLayout = FEMNIST_MLP) -> dict:
    """Flat tensor -> nested dict of numpy arrays with the reference's
    leaf names and shapes (what the reference's `jax.device_get` gives)."""
    return layout.to_tree(flat)
