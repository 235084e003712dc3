"""Seed-made weights on the device, in the type they are trained in.

The leaves' names and shapes are the program's checkpoint layout (a tree
of dicts and lists, segment leaves with a leading layer axis); their
values come from the configuration file's "init" table, by leaf name:

  {"normal": std}              N(0, std^2)
  {"trunc_normal": std}        N(0, 1) cut to [-2, 2], times std;
                               "fan_in" for the per-layer shape's
                               fan-in^-1/2 (its second-to-last size)
  {"const": c}                 c everywhere
  {"log_linspace": [a, b]}     log(linspace(a, b, n)) along the last axis
  {"decay_base": [lo, span, p]} lo + span (i / (n - 1))^p along the last axis

and "default" for a leaf the table does not name. All drawn leaves come
from two calls of one generator on the device (one for each kind of
draw) over a flat float32 buffer, so the weights are the same for a seed
whatever the device's thread count, and are made in a fraction of a
second at full width.
"""
from __future__ import annotations

import math

import torch

from bench import harness


def _per_layer(path: str, shape: tuple) -> tuple:
    return tuple(shape[1:]) if path.startswith("segments/") else tuple(shape)


def _std(spec, path: str, shape: tuple) -> float:
    if spec != "fan_in":
        return float(spec)
    lay = _per_layer(path, shape)
    return (lay[-2] if len(lay) >= 2 else lay[-1]) ** -0.5


def make(layout, init: dict, seed: int, device, dtype) -> dict:
    """Weights of `layout` (a tree whose leaves carry `.shape`, such as
    the program's parameters on the `meta` device) as `dtype` tensors on
    `device`, from `seed`."""
    items = harness.tree_items(layout)
    spec_of = {p: init.get(p.rsplit("/", 1)[-1], init["default"])
               for p, _ in items}
    drawn = {kind: [(p, t) for p, t in items if kind in spec_of[p]]
             for kind in ("normal", "trunc_normal")}
    gen = torch.Generator(device=device).manual_seed(
        harness.derive_seed(seed, "weights"))
    values: dict[str, torch.Tensor] = {}
    for kind, leaves in drawn.items():
        n = sum(math.prod(t.shape) for _, t in leaves)
        if not n:
            continue
        flat = torch.empty(n, dtype=torch.float32, device=device)
        if kind == "normal":
            flat.normal_(generator=gen)
        else:
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
        off = 0
        for p, t in leaves:
            size = math.prod(t.shape)
            std = _std(spec_of[p][kind], p, tuple(t.shape))
            values[p] = (flat[off:off + size].view(t.shape) * std).to(dtype)
            off += size
        del flat
    for p, t in items:
        if p in values:
            continue
        spec = spec_of[p]
        shape = tuple(t.shape)
        if "const" in spec:
            values[p] = torch.full(shape, float(spec["const"]), dtype=dtype,
                                   device=device)
            continue
        n = shape[-1]
        i = torch.arange(n, dtype=torch.float64, device=device)
        if "log_linspace" in spec:
            a, b = spec["log_linspace"]
            row = torch.log(torch.linspace(a, b, n, dtype=torch.float64,
                                           device=device))
        elif "decay_base" in spec:
            lo, span, power = spec["decay_base"]
            row = lo + span * (i / max(n - 1, 1)) ** power
        else:
            raise ValueError(f"leaf {p}: unknown init {spec}")
        values[p] = row.to(dtype).expand(shape).clone()
    order = iter([values[p] for p, _ in items])
    return _rebuild(layout, order)


def _rebuild(tree, order):
    """`tree`'s structure with its leaves taken from `order` in
    `harness.tree_items` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], order) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, order) for v in tree]
    return next(order)
