"""Dispatch for the port's kernels, with launch counters.

A tensor on the CPU takes the kernel's plain PyTorch version
(`repro_torch.kernels.ref`), and so does one on the `meta` device (the
dry run's shapes-only tensors, DTensor shards included), as the
reference's dry run keeps its jnp attention; any other tensor goes to
the CUDA kernel, which launches or raises — there is no fallback.
`LAUNCHES` counts kernel
launches (and only those), so a run can show that its main path went
through the kernels. Port of `repro.kernels.ops`: the simulator's two
kernels (`fedagg`, `prox_sgd`) and the LM's two (`flash_attention`,
`wkv6`), and the port's own SSD heads op (`ssd_heads_op`: the
elementwise work on each side of `wkv6` in the hybrid blocks, which the
reference leaves to XLA).

`flash_attention_op`, `wkv6_op` and `ssd_heads_op` are differentiable
(`torch.autograd.Function`): their backward is a kernel too
(`flash_attention_bwd`, `wkv6_bwd`, the `ssd_*_bwd` kernels and the
reduction `ssd_reduce`, counted under those names), or on
the CPU the plain backward of `ref`, the kernel's own formulas written
out (not autograd of the plain forward). Where a gradient is wanted the
forward keeps what the backward would otherwise recompute: each
attention row's log-sum-exp, and each scan chunk's start state. The
reference has no backward kernel: it differentiates its jnp attention
and scan.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ref, ssd
from repro_torch.kernels.fedagg import fedagg
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.prox_sgd import prox_sgd
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
from repro_torch.params import leaves_with_paths, unflatten_like

LAUNCHES = {"fedagg": 0, "prox_sgd": 0, "flash_attention": 0, "wkv6": 0,
            "flash_attention_bwd": 0, "wkv6_bwd": 0, "ssd_front": 0,
            "ssd_back": 0, "ssd_back_bwd": 0, "ssd_front_bwd": 0,
            "ssd_reduce": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Devices whose tensors take the plain versions (and count no launch).
PLAIN_DEVICES = ("cpu", "meta")


def _plain(t: torch.Tensor) -> bool:
    return t.device.type in PLAIN_DEVICES


def fedagg_op(x: torch.Tensor, w: torch.Tensor,
              base: torch.Tensor | None = None,
              scale: float | torch.Tensor = 1.0,
              partial: bool = False) -> torch.Tensor:
    """sum_k w[k] * x[k] over (K, P), or its delta form against `base`
    (with `partial`, its weighted deltas alone: a mesh rank's share of
    the round); over (S, K, P) with a leading scenario axis (w (S, K),
    base (S, P), scale an (S,) float32 tensor), one launch for every
    scenario."""
    if _plain(x):
        if x.dim() == 3:
            return ref.fedagg_batched_ref(x, w, base, scale)
        return ref.fedagg_ref(x, w, base, scale, partial)
    out = fedagg(x, w, base, scale, partial)
    LAUNCHES["fedagg"] += 1
    return out


def prox_sgd_op(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
                steps: torch.Tensor, step: int, lr: float,
                mu: float | torch.Tensor) -> torch.Tensor:
    """In-place masked proximal SGD step over a (C, P) client stack; `mu`
    a float or a (C,) tensor, `w0` (P,), (C, P) or (G, P) anchors (row c
    reads row c // (C / G))."""
    if _plain(w):
        if isinstance(mu, torch.Tensor) or (
                w0.dim() == 2 and w0.shape[0] not in (1, w.shape[0])):
            return ref.prox_sgd_rows_ref_(w, g, w0, steps, step, lr, mu)
        return ref.prox_sgd_masked_ref_(w, g, w0, steps, step, lr, mu)
    prox_sgd(w, g, w0, steps, step, lr, mu)
    LAUNCHES["prox_sgd"] += 1
    return w


def fedagg_pytree(stacked, w: torch.Tensor):
    """Weighted-average a stacked client tree (dicts and lists of (K, ...)
    leaves) through ONE `fedagg` launch: the leaves flattened to one
    float32 (K, P) buffer in `jax.tree.leaves` order, the (P,) result
    split back, each leaf in its own dtype (the reference's
    `fedagg_pytree`)."""
    leaves = [leaf for _, leaf in leaves_with_paths(stacked)]
    K = leaves[0].shape[0]
    flat = torch.cat([l.reshape(K, -1).float() for l in leaves], dim=1)
    out = fedagg_op(flat, w.float())
    pieces = torch.split(out, [l[0].numel() for l in leaves])
    return unflatten_like(stacked, [p.view(l.shape[1:]).to(l.dtype)
                                    for p, l in zip(pieces, leaves)])


def prox_sgd_pytree(params, grads, anchor, lr: float, mu: float):
    """`w - lr * (g + mu * (w - w0))` leaf by leaf over three trees of the
    same structure, one `prox_sgd` launch a leaf, into new tensors (the
    reference's `prox_sgd_pytree`)."""
    outs = []
    for (_, p), (_, g), (_, a) in zip(leaves_with_paths(params),
                                      leaves_with_paths(grads),
                                      leaves_with_paths(anchor)):
        w = p.reshape(1, -1).clone(memory_format=torch.contiguous_format)
        live = torch.ones(1, dtype=torch.int32, device=p.device)
        prox_sgd_op(w, g.reshape(1, -1).contiguous(),
                    a.reshape(-1).contiguous(), live, 0, lr, mu)
        outs.append(w.view(p.shape))
    return unflatten_like(params, outs)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        keep = any(ctx.needs_input_grad[:3])     # lse, for the backward
        if _plain(q):
            out = ref.flash_attention_ref(q, k, v, causal, window, softcap,
                                          return_lse=keep)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, return_lse=keep)
            LAUNCHES["flash_attention"] += 1
        o, lse = out if keep else (out, None)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.masks
        if _plain(q):
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, do,
                                                     *ctx.masks, lse=lse)
        else:
            if do.stride(-1) != 1:
                do = do.contiguous()
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                             causal=causal, window=window,
                                             softcap=softcap)
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int | None = None,
                       softcap: float | None = None) -> torch.Tensor:
    """GQA attention of queries at positions 0..S-1 against keys at
    0..Sk-1: q (B, H, S, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv) -> (B,
    H, S, Dv), Dv = D or MLA's smaller value head dim; Sk = S but for
    cross-attention, which takes no mask. The kernel's tiles are fixed,
    so the reference's `bq`/`bk` have no counterpart. Differentiable (dk
    and dv of the keys' length)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, s0, chunk):
        # Each chunk's start state, for the backward (13 MB a layer at
        # full-width hymba-1.5b, batch 2 x 2048).
        keep = any(ctx.needs_input_grad[:5])
        if _plain(r):
            out = ref.wkv6_ref(r, k, v, logw, s0, chunk, return_states=keep)
        else:
            out = wkv6(r, k, v, logw, s0, chunk=chunk, return_states=keep)
            LAUNCHES["wkv6"] += 1
        o, s_final, *states = out
        ctx.save_for_backward(r, k, v, logw, s0, *states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, s_final

    @staticmethod
    def backward(ctx, do, ds_final):
        r, k, v, logw, s0, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        if _plain(r):
            grads = ref.wkv6_bwd_ref(r, k, v, logw, s0, do, ds_final,
                                     ctx.chunk, states)
        else:
            grads = wkv6_bwd(r, k, v, logw, s0, do, ds_final, states,
                             chunk=ctx.chunk)
            LAUNCHES["wkv6_bwd"] += 1
        return (*grads, None)


def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, s0: torch.Tensor, *,
            chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Strict-past chunked decay scan -> (o (B, H, T, V), s_final).
    Differentiable in every input (broadcast views too: autograd sums the
    dense gradients back over their expanded axes)."""
    return _Wkv6.apply(r, k, v, logw, s0, chunk)


class _SSDHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, d_skip,
                out_norm, s0, conv_tail, seq_len, head_dim, chunk):
        G, n, E2 = xz.shape
        T, N = seq_len, bt.shape[-1]
        GB, H = G * (n // T), E2 // 2 // head_dim
        keep = any(ctx.needs_input_grad[:12])
        s0_given = s0 is not None
        s0 = s0.float() if s0_given else torch.zeros(
            (GB, H, N, head_dim), dtype=torch.float32, device=xz.device)
        plain = _plain(xz)
        if plain:
            xh, r, v, k, dt, logw = ref.ssd_front_ref(
                xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, conv_tail,
                T, head_dim)
        else:
            xh, r, v, k, dt, logw = ssd.ssd_front(
                xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, conv_tail,
                T, head_dim)
            LAUNCHES["ssd_front"] += 1
        # The scan through the model's scan core, on leaves of its own
        # graph when a gradient is wanted: the backward takes the scan's
        # gradients from that graph, dense for k's and logw's broadcast
        # views (summed back over heads and the state dim by the front
        # kernel's backward).
        scan_in = (r.transpose(1, 2),
                   k.reshape(GB, 1, T, N).expand(GB, H, T, N),
                   v.transpose(1, 2),
                   logw.reshape(GB, T, H).transpose(1, 2)[..., None]
                   .expand(GB, H, T, N), s0)
        if keep:
            scan_in = [t.detach().requires_grad_(True) for t in scan_in]
        with torch.enable_grad() if keep else contextlib.nullcontext():
            o, s_final = _scan_core().chunked_decay_scan(*scan_in,
                                                         chunk=chunk)
        o_val = o.detach().transpose(1, 2)           # (G B, T, H, head_dim)
        if plain:
            y, rstd = ref.ssd_back_ref(o_val, xh, xz, bt, ct, dt, d_skip,
                                       out_norm, head_dim)
        else:
            y, rstd = ssd.ssd_back(o_val, xh, xz, bt, ct, dt, d_skip,
                                   out_norm, head_dim)
            LAUNCHES["ssd_back"] += 1
        if keep:
            ctx.save_for_backward(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b,
                                  a_log, d_skip, out_norm, conv_tail, xh, dt,
                                  logw, o_val, rstd)
            ctx.scan = (o, s_final, scan_in)
            ctx.dims = (T, head_dim, s0_given)
        ctx.set_materialize_grads(False)
        return y, s_final.detach()

    @staticmethod
    def backward(ctx, dy, ds_final):
        (xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, d_skip, out_norm,
         conv_tail, xh, dt, logw, o, rstd) = ctx.saved_tensors
        scan_o, scan_s, scan_in = ctx.scan
        T, head_dim, s0_given = ctx.dims
        if dy is None:
            dy = torch.zeros(xh.shape, dtype=xh.dtype, device=xh.device)
        plain = _plain(xz)
        back = (o, xh, xz, bt, ct, dt, d_skip, out_norm, rstd)
        if plain:
            du, dz, p2, dnorm = ref.ssd_back_bwd_ref(dy, *back, head_dim)
        else:
            dxz = torch.empty_like(xz)
            du, p2, norm_part = ssd.ssd_back_bwd(dy.contiguous(), *back,
                                                 head_dim, dxz)
            LAUNCHES["ssd_back_bwd"] += 1
        do = du.view(o.shape).transpose(1, 2)
        outs, grads = ((scan_o,), (do,)) if ds_final is None \
            else ((scan_o, scan_s), (do, ds_final))
        dr, dk, dv, dlw, ds0 = torch.autograd.grad(outs, scan_in, grads,
                                                   allow_unused=True)
        front = (du, dv, dr, dk, dlw, p2, xz, dt_raw, bt, ct, conv_w, conv_b,
                 dt_b, a_log, d_skip, conv_tail, dt, logw)
        if plain:
            dxs, *grads, dtail = ref.ssd_front_bwd_ref(*front, T, head_dim)
            dxz = torch.cat([dxs, dz], dim=-1)
            dnorm = dnorm.to(out_norm.dtype)
        else:
            *grads, dnorm, dtail = ssd.ssd_front_bwd(*front, T, head_dim,
                                                     dxz, norm_part)
            LAUNCHES["ssd_front_bwd"] += 1
            LAUNCHES["ssd_reduce"] += 1
        return (dxz, *grads, dnorm, ds0 if s0_given else None, dtail,
                None, None, None)


def _scan_core():
    """`models.lm.scan_core`, which imports this module: the model's one
    entry to the scan, looked up when called."""
    from repro_torch.models.lm import scan_core
    return scan_core


def ssd_heads_op(xz: torch.Tensor, dt_raw: torch.Tensor, bt: torch.Tensor,
                 ct: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 dt_b: torch.Tensor, a_log: torch.Tensor,
                 d_skip: torch.Tensor, out_norm: torch.Tensor,
                 s0: torch.Tensor | None, conv_tail: torch.Tensor | None, *,
                 seq_len: int, head_dim: int, chunk: int = 64
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD heads between their projections (shapes in
    `ref.ssd_front_ref`; s0 (G B, H, N, head_dim) f32 or None for zeros)
    -> (y (G, n, E) in the model's dtype, ready for `out_proj`; the scan's
    end state (G B, H, N, head_dim) f32). Three launches: the conv front
    and the scan's inputs (`ssd_front`), the scan (`wkv6`), the diagonal,
    D skip, gate and RMSNorm (`ssd_back`); the backward runs their
    backward kernels in reverse (`ssd_back_bwd`, `wkv6_bwd`,
    `ssd_front_bwd`) and one reduction of the weights' block partials
    (`ssd_reduce`). Differentiable in every tensor input."""
    return _SSDHeads.apply(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log,
                           d_skip, out_norm, s0, conv_tail, seq_len,
                           head_dim, chunk)


__all__ = ["LAUNCHES", "reset_launches", "fedagg_op", "fedagg_pytree",
           "flash_attention_op", "prox_sgd_op", "prox_sgd_pytree",
           "ssd_heads_op", "wkv6_op", "ref"]
