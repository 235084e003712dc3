"""47k-parameter MLP client model (port of `repro.models.femnist_mlp`).

784 -> 56 -> 47 = 46,639 parameters. Parameters live in one flat buffer
(`repro_torch.params.FEMNIST_MLP`); `femnist_mlp_apply` takes the nested
dict of views, for one client ((P,) buffer, x (N, 28, 28, 1)) or for a
stacked client axis ((C, P) buffer, x (C, N, 28, 28, 1)).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.params import FEMNIST_MLP

# `jax.nn.initializers.he_normal` is variance_scaling(2, "fan_in",
# "truncated_normal"): a standard normal truncated to [-2, 2], rescaled by
# this constant (its standard deviation) so the variance stays 2 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _he_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """In place, with jax's fan-in: every axis but the last (an HWIO conv
    kernel's receptive field times its input channels)."""
    std = math.sqrt(2.0 / math.prod(w.shape[:-1])) / _TRUNC_STD
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)


def femnist_mlp_init(generator: torch.Generator, device=None) -> torch.Tensor:
    """Flat (P,) params on `device` (CUDA unless asked otherwise):
    He-normal (truncated at 2 sigma) weights, zero biases. The
    distribution matches the reference's; the values do not (torch and
    jax generators differ)."""
    flat = torch.zeros(FEMNIST_MLP.size, dtype=torch.float32,
                       device=resolve_device(device))
    views = FEMNIST_MLP.views(flat)
    with torch.no_grad():
        _he_normal_(views["fc1"]["w"], generator)
        _he_normal_(views["fc2"]["w"], generator)
    return flat


def femnist_mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (N, 47), or (C, N, 47) for a stacked client axis."""
    w1, b1 = params["fc1"]["w"], params["fc1"]["b"]
    w2, b2 = params["fc2"]["w"], params["fc2"]["b"]
    h = x.flatten(start_dim=w1.dim() - 1)             # (N, 784) / (C, N, 784)
    h = torch.relu(torch.matmul(h, w1) + b1.unsqueeze(-2))
    return torch.matmul(h, w2) + b2.unsqueeze(-2)
