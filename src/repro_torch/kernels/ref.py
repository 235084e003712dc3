"""Plain PyTorch versions of the kernels (the correctness contract).

`repro_torch.kernels.ops` takes these for tensors that lie on the CPU;
`chip_smoke.py` holds each CUDA kernel against them on the card. Mirrors
`repro.kernels.ref`; `wkv6_ref` is the chunked form the TPU kernel
computes (the reference's oracle is a step-by-step scan, which
`tests/test_torch_lm_kernels.py` holds it against).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fedagg_ref(x: torch.Tensor, w: torch.Tensor,
               base: torch.Tensor | None = None,
               scale: float = 1.0, partial: bool = False) -> torch.Tensor:
    """x (K, P), w (K,) -> (P,): sum_k w[k] * x[k] in float32, stored in
    x.dtype. With `base` (P,): base + scale * sum_k w[k] * (x[k] - base),
    or with `partial` only the sum, sum_k w[k] * (x[k] - base)."""
    x32, w32 = x.float(), w.float()[:, None]
    if base is None:
        if partial:
            raise ValueError("fedagg: the partial form needs a base")
        return (w32 * x32).sum(0).to(x.dtype)
    b32 = base.float()
    acc = (w32 * (x32 - b32)).sum(0)
    if partial:
        return acc.to(x.dtype)
    return (b32 + scale * acc).to(x.dtype)


def prox_sgd_ref(w, g, w0, lr: float, mu: float) -> torch.Tensor:
    """w - lr * (g + mu * (w - w0)) elementwise in float32 (w0 broadcasts)."""
    w32, g32, w032 = w.float(), g.float(), w0.float()
    return (w32 - lr * (g32 + mu * (w32 - w032))).to(w.dtype)


def prox_sgd_masked_ref_(w: torch.Tensor, g: torch.Tensor,
                         w0: torch.Tensor, steps: torch.Tensor, step: int,
                         lr: float, mu: float) -> torch.Tensor:
    """In-place masked client step over a (C, P) buffer: rows with
    `step < steps[c]` take `prox_sgd_ref`, the others keep their bits."""
    live = (step < steps)[:, None]
    return w.copy_(torch.where(live, prox_sgd_ref(w, g, w0, lr, mu), w))


def prox_sgd_rows_ref_(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
                       steps: torch.Tensor, step: int, lr: float,
                       mu) -> torch.Tensor:
    """The kernel's extended form, in place over an (R, P) buffer: per-row
    `mu` ((R,) float32, or one float) and grouped anchors (w0 (G, P) with
    R % G == 0, row r reading anchor row r // (R / G); a (P,) anchor is
    G = 1). A loop of `prox_sgd_masked_ref_` over the rows, one at a time."""
    R, P = w.shape
    anchors = w0.reshape(-1, P)
    group = R // anchors.shape[0]
    for r in range(R):
        mu_r = float(mu[r]) if isinstance(mu, torch.Tensor) else mu
        prox_sgd_masked_ref_(w[r:r + 1], g[r:r + 1], anchors[r // group],
                             steps[r:r + 1], step, lr, mu_r)
    return w


def fedagg_batched_ref(x: torch.Tensor, w: torch.Tensor,
                       base: torch.Tensor | None = None,
                       scale: torch.Tensor | float = 1.0) -> torch.Tensor:
    """The kernel's scenario-batched form: x (S, K, P), w (S, K), base
    (S, P) or None, scale (S,) float32 or one float (with base) -> (S, P).
    A loop of `fedagg_ref` over the scenarios."""
    def scale_of(s: int) -> float:
        return float(scale[s]) if isinstance(scale, torch.Tensor) else scale

    return torch.stack([
        fedagg_ref(x[s], w[s], None if base is None else base[s],
                   scale_of(s)) for s in range(x.shape[0])])


def _pair_mask(S: int, Sk: int, causal: bool, window: int | None,
               device) -> torch.Tensor:
    """(S, Sk) bool: whether query qpos (0..S-1) attends to key kpos
    (0..Sk-1)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _row_lse(s: torch.Tensor) -> torch.Tensor:
    """log sum exp over the last axis of masked scores, the sum clamped at
    1e-30 as the kernels' denominator, without the last axis."""
    m = s.amax(-1, keepdim=True)
    return (m + torch.log(torch.clamp(torch.exp(s - m).sum(-1, keepdim=True),
                                      min=1e-30)))[..., 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        return_lse: bool = False):
    """q: (B,H,S,D), k: (B,KV,Sk,D), v: (B,KV,Sk,Dv) -> (B,H,S,Dv) in
    q.dtype (Dv = D, or MLA's value head dim), scaled by D^-1/2. Naive
    softmax in f32 of queries at positions 0..S-1 against keys at
    0..Sk-1 (Sk = S but for cross-attention); query head h reads KV head
    h // (H / KV). A pair counts if `kpos <= qpos` (causal) and
    `qpos - kpos < window`. With `return_lse`, also each row's
    log-sum-exp over its counted pairs, (B,H,S) float32, as the kernel
    writes it for the backward."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(_pair_mask(S, k.shape[2], causal, window, q.device), s,
                    -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return (o, _row_lse(s)) if return_lse else o


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, s0: torch.Tensor, chunk: int = 64,
             return_states: bool = False) -> tuple[torch.Tensor, ...]:
    """Strict-past chunked decay scan, f32. r/k/logw: (B,H,T,K); v:
    (B,H,T,V); s0: (B,H,K,V) -> (o (B,H,T,V), s_final (B,H,K,V)); with
    `return_states`, also the start states of chunks 1 .. n - 1,
    (n - 1, B,H,K,V) for n = ceil(T / chunk) chunks, as the kernel keeps
    them for the backward.

    T is zero-padded to a multiple of `chunk` (zero r/k/v with logw = 0
    leave the state unchanged). Per chunk, with logc the inclusive and
    logb = logc - logw the exclusive cumulative log decay:
      o = (r exp(logb)) @ S + A @ v,
      A[t, i] = sum_k r[t,k] k[i,k] exp(min(logb[t,k] - logc[i,k], 0)), i < t
      S = S exp(logc[-1]) + (k exp(logc[-1] - logc))^T v
    """
    B, H, T, K = r.shape
    pad = (-T) % chunk
    r, k, v, logw = (F.pad(x.float(), (0, 0, 0, pad))
                     for x in (r, k, v, logw))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    s = s0.float()
    outs, states = [], []
    for c in range(0, T + pad, chunk):
        if c:
            states.append(s)
        rc, kc, vc, wc = (x[:, :, c:c + chunk] for x in (r, k, v, logw))
        logc = torch.cumsum(wc, dim=2)
        logb = logc - wc
        o = torch.einsum("bhtk,bhkv->bhtv", rc * torch.exp(logb), s)
        d = logb[:, :, :, None, :] - logc[:, :, None, :, :]   # (B,H,L,L,K)
        a = (rc[:, :, :, None, :] * kc[:, :, None, :, :]
             * torch.exp(torch.clamp(d, max=0.0))).sum(-1)
        a = torch.where(tri, a, 0.0)
        outs.append(o + torch.einsum("bhti,bhiv->bhtv", a, vc))
        total = logc[:, :, -1:, :]
        kd = kc * torch.exp(total - logc)
        s = s * torch.exp(total[:, :, 0, :, None]) \
            + torch.einsum("bhik,bhiv->bhkv", kd, vc)
    o = torch.cat(outs, dim=2)[:, :, :T]
    if not return_states:
        return o, s
    return o, s, (torch.stack(states) if states else
                  s.new_empty((0, *s.shape)))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None,
                            lse: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward kernel's formulas (`csrc/flash_attention_bwd.cu`), in
    f32: q (B,H,S,D), k (B,KV,Sk,D), v (B,KV,Sk,Dv), o the forward's
    output and do its gradient (B,H,S,Dv) -> (dq, dk, dv) in the input
    dtypes (dk and dv of the keys' length Sk, dv of v's Dv).

    Row statistics first: lse = log sum_k exp(s) over the counted pairs
    (the forward's, `flash_attention_ref(..., return_lse=True)`, when
    given; else recomputed the same way) and delta = sum_d do o. Then
      p  = exp(s - lse) (exactly 0 where masked),
      dv = sum over the KV head's query heads of p^T do,
      ds = p (do v^T - delta) softcap'(raw) scale,
      dq = ds k,  dk = sum over the KV head's query heads of ds^T q,
    with raw = q.k scale and softcap'(raw) = 1 - tanh(raw / cap)^2."""
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = D ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    dscore = torch.full((), scale, device=q.device)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dscore = (1.0 - t * t) * scale
    mask = _pair_mask(S, Sk, causal, window, q.device)
    s = torch.where(mask, s, -1e30)
    lse = (_row_lse(s) if lse is None else lse.float())[..., None]
    delta = (dof * of).sum(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta) * dscore
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).view(B, KV, rep, Sk, D) \
        .sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).view(B, KV, rep, Sk, -1) \
        .sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, s0: torch.Tensor, do: torch.Tensor,
                 ds_final: torch.Tensor | None = None, chunk: int = 64,
                 states: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """The backward kernel's formulas (`csrc/wkv6_bwd.cu`), in f32: the
    inputs of `wkv6_ref`, do (B,H,T,V) the gradient of o and ds_final
    (B,H,K,V) that of the end state (None: zero) -> (dr, dk, dv, dlogw,
    ds0).

    Each chunk's start state S is s0 or, for chunk c > 0, `states[c - 1]`
    (the forward's, `wkv6_ref(..., return_states=True)`); without
    `states` a forward pass recomputes them (never dividing by the
    decay). Then, from the last chunk back, with dS the gradient of the
    chunk's end state, logc / logb the inclusive / exclusive cumulative
    log decay and e[t,i,k] = exp(min(logb[t,k] - logc[i,k], 0)):
      A[t,i] = sum_k r[t,k] k[i,k] e[t,i,k],  dA[t,i] = do[t] . v[i]
               (both for i < t, else 0)
      dv[i]  = sum_{t>i} A[t,i] do[t] + (k[i] exp(logc[-1] - logc[i]))^T dS
      dr[t]  = exp(logb[t]) (S do[t]) + sum_{i<t} dA[t,i] k[i] e[t,i]
      dk[i]  = sum_{t>i} dA[t,i] r[t] e[t,i]
               + exp(logc[-1] - logc[i]) (dS v[i])
      dS    <- dS exp(logc[-1]) + sum_t (r[t] exp(logb[t]))^T do[t]
    and dlogw[s] = sum_{t>=s} (q_t - p_t) - q_s + sum_v dS_T S_T over the
    whole sequence, with q = r dr and p = k dk."""
    B, H, T, K = r.shape
    pad = (-T) % chunk
    r, k, v, logw, do = (F.pad(x.float(), (0, 0, 0, pad))
                         for x in (r, k, v, logw, do))
    n = (T + pad) // chunk
    seg = lambda x, c: x[:, :, c * chunk:(c + 1) * chunk]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)

    def carry_past(s, c):
        kc, vc, logc = seg(k, c), seg(v, c), torch.cumsum(seg(logw, c), 2)
        total = logc[:, :, -1:, :]
        return s * torch.exp(total[:, :, 0, :, None]) + torch.einsum(
            "bhik,bhiv->bhkv", kc * torch.exp(total - logc), vc)

    if states is None:
        starts = [s0.float()]
        for c in range(n - 1):
            starts.append(carry_past(starts[-1], c))
    else:
        starts = [s0.float(), *states.float()]
    s = carry_past(starts[-1], n - 1)                    # the end state
    ds = (torch.zeros_like(s) if ds_final is None else ds_final.float())
    carry = (ds * s).sum(-1)                              # (B, H, K)
    grads = []
    for c in reversed(range(n)):
        rc, kc, vc, wc, gc = (seg(x, c) for x in (r, k, v, logw, do))
        logc = torch.cumsum(wc, 2)
        logb = logc - wc
        total = logc[:, :, -1:, :]
        e = torch.exp(torch.clamp(logb[:, :, :, None, :]
                                  - logc[:, :, None, :, :], max=0.0))
        a = torch.where(tri, (rc[:, :, :, None, :] * kc[:, :, None, :, :]
                              * e).sum(-1), 0.0)
        da = torch.where(tri, torch.einsum("bhtv,bhiv->bhti", gc, vc), 0.0)
        dv = torch.einsum("bhti,bhtv->bhiv", a, gc) + torch.einsum(
            "bhik,bhkv->bhiv", kc * torch.exp(total - logc), ds)
        dr = torch.exp(logb) * torch.einsum("bhkv,bhtv->bhtk", starts[c], gc) \
            + (da[..., None] * kc[:, :, None, :, :] * e).sum(3)
        dk = (da[..., None] * rc[:, :, :, None, :] * e).sum(2) \
            + torch.exp(total - logc) * torch.einsum("bhkv,bhiv->bhik", ds, vc)
        q, p = rc * dr, kc * dk
        suffix = torch.flip(torch.cumsum(torch.flip(q - p, (2,)), 2), (2,))
        grads.append((dr, dk, dv, carry[:, :, None, :] + suffix - q))
        carry = carry + (q - p).sum(2)
        ds = ds * torch.exp(total[:, :, 0, :, None]) + torch.einsum(
            "bhtk,bhtv->bhkv", rc * torch.exp(logb), gc)
    dr, dk, dv, dlogw = (torch.cat(g[::-1], dim=2)[:, :, :T]
                         for g in zip(*grads))
    return dr, dk, dv, dlogw, ds
