"""The paper's 47,887-parameter CNN client model (port of
`repro.models.femnist_cnn`, section 5: "47k parameters / 186 KB").

conv(1->8, 3x3) -> pool2 -> conv(8->16, 3x3) -> pool2 -> dense(784->56)
-> dense(56->47). Parameters live in one flat buffer
(`repro_torch.params.FEMNIST_CNN`); `femnist_cnn_apply` takes the nested
dict of views, for one client ((P,) buffer, x (N, 28, 28, 1)) or for a
stacked client axis ((C, P) buffer, x (C, N, 28, 28, 1)).

Like the reference, the convolutions are im2col + matmul (a batched
matmul over the client axis, where every client has its own kernel) and
the max-pool is a reshape; activations stay NHWC, so the flatten before
`fc1` orders its 784 inputs as the reference's does. Each conv carries
its bias as one more row of its kernel, against a column of ones in the
patches, so the bias gradient comes out of the same batched matrix
product as the kernel's: on the card a reduction kernel's summation
order depends on how many clients are stacked, and this product's does
not, so a client's update has the same bits alone (the loop path) or in
a batch of scenarios (`repro_torch.sim.batched`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.femnist_mlp import _he_normal_
from repro_torch.params import FEMNIST_CNN, leaves_with_paths


def femnist_cnn_init(generator: torch.Generator, device=None) -> torch.Tensor:
    """Flat (P,) params on `device` (CUDA unless asked otherwise):
    He-normal (truncated at 2 sigma, fan-in of every axis but the last)
    weights, zero biases. The distribution matches the reference's; the
    values do not (torch and jax generators differ)."""
    flat = torch.zeros(FEMNIST_CNN.size, dtype=torch.float32,
                       device=resolve_device(device))
    views = FEMNIST_CNN.views(flat)
    with torch.no_grad():
        for layer in ("conv1", "conv2", "fc1", "fc2"):
            _he_normal_(views[layer]["w"], generator)
    return flat


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv via im2col + matmul. x: ([C,] B, H, W, Cin); w:
    ([C,] kh, kw, Cin, Cout); b: ([C,] Cout) -> ([C,] B, H, W, Cout)."""
    kh, kw, cin, cout = w.shape[-4:]
    h, wd = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = torch.stack(
        [xp[..., i:i + h, j:j + wd, :] for i in range(kh) for j in range(kw)],
        dim=-2).flatten(-2)                       # ([C,] B, H, W, kh*kw*Cin)
    # The bias as the kernel's last row, against a column of ones.
    patches = F.pad(patches, (0, 1), value=1.0)
    k = torch.cat([w.flatten(-4, -2), b.unsqueeze(-2)], dim=-2)
    n_lead = w.dim() - 4                          # 1 with a client axis
    lead = patches.shape[:-1]                     # ([C,] B, H, W)
    out = torch.matmul(
        patches.reshape(*lead[:n_lead], -1, patches.shape[-1]), k)
    return out.reshape(*lead, cout)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool by reshape: ([C,] B, H, W, Ch) -> ([C,] B, H/2, W/2,
    Ch)."""
    h, w = x.shape[-3], x.shape[-2]
    x = x.unflatten(-2, (w // 2, 2)).unflatten(-4, (h // 2, 2))
    return x.amax(dim=(-4, -2))


def femnist_cnn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (N, 47), or (C, N, 47) for a stacked client axis."""
    h = _pool2(torch.relu(_conv(x, params["conv1"]["w"],
                                params["conv1"]["b"])))
    h = _pool2(torch.relu(_conv(h, params["conv2"]["w"],
                                params["conv2"]["b"])))
    h = h.flatten(start_dim=-3)                   # NHWC order, as reshape
    w1, b1 = params["fc1"]["w"], params["fc1"]["b"]
    w2, b2 = params["fc2"]["w"], params["fc2"]["b"]
    h = torch.relu(torch.matmul(h, w1) + b1.unsqueeze(-2))
    return torch.matmul(h, w2) + b2.unsqueeze(-2)


def count_params(params) -> int:
    """Parameters in a tree of arrays or tensors (or one flat buffer):
    the reference's `count_params`. 47,887 for this model."""
    return sum(math.prod(leaf.shape) for _, leaf in leaves_with_paths(params))
