"""Plain PyTorch versions of the kernels (the correctness contract).

`repro_torch.kernels.ops` takes these for tensors that lie on the CPU;
`chip_smoke.py` holds each CUDA kernel against them on the card. Mirrors
`repro.kernels.ref`; `wkv6_ref` is the chunked form the TPU kernel
computes (the reference's oracle is a step-by-step scan, which
`tests/test_torch_lm_kernels.py` holds it against). The `ssd_*_ref`
functions are the plain versions of the port's own SSD kernels, which
have no TPU kernel behind them (`tests/test_torch_lm.py` holds their
hand-written backward against autograd and `jax.grad`).
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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """The reference's naive-softmax oracle: q (B, H, S, D), k / v (B, KV,
    S, D) -> (B, H, S, D) in q's dtype; every (S, S) score in float32,
    masked scores at -1e30 (`flash_attention_ref` is the kernel's own
    contract, with keys of their own length and value head dims)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


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
    leave the state unchanged). On `meta` tensors the chunk loop runs
    as one step over a chunk axis (`_wkv6_shapes`). Per chunk, with logc
    the inclusive and
    logb = logc - logw the exclusive cumulative log decay:
      o = (r exp(logb)) @ S + A @ v,
      A[t, i] = sum_k r[t,k] k[i,k] exp(min(logb[t,k] - logc[i,k], 0)), i < t
      S = S exp(logc[-1]) + (k exp(logc[-1] - logc))^T v
    """
    if r.device.type == "meta":
        return _wkv6_shapes(r, k, v, logw, s0, chunk, return_states)
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
    whole sequence, with q = r dr and p = k dk. On `meta` tensors the
    chunk loops run as one step over a chunk axis
    (`_wkv6_bwd_shapes`)."""
    if r.device.type == "meta":
        return _wkv6_bwd_shapes(r, k, v, logw, s0, do, ds_final, chunk,
                                states)
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


# ----------------------------------------------------------------------- #
# The scans on `meta` tensors (the dry run): shapes, FLOPs and bytes only
# ----------------------------------------------------------------------- #
# A meta tensor has no values, so the chunk loops above carry nothing from
# one chunk to the next; what a shapes-only run needs of them is each
# chunk's ops at their shapes. These forms run the n chunk steps as one
# step over a chunk axis (B, H, n, L, .): every product is the loop's at
# the loop's shapes, batched, so the FLOPs and the elements touched are
# the loop's, in a handful of ops where the loop dispatches ~50 per chunk
# (512 chunks a layer at 32k positions). Only meta tensors take them.
def _chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, H, T, E) f32, zero-padded to n chunks -> (B, H, n, chunk, E)."""
    B, H, T, E = x.shape
    x = x.float()
    if T % chunk:
        x = F.pad(x, (0, 0, 0, (-T) % chunk))
    return x.reshape(B, H, -1, chunk, E)


def _chunk_terms(rc, kc, wc, tri):
    """Per chunk (batched over the chunk axis): the decays and the
    intra-chunk matrix A (masked strictly below the diagonal)."""
    logc = torch.cumsum(wc, dim=3)
    logb = logc - wc
    e = torch.exp(torch.clamp(logb[..., :, None, :] - logc[..., None, :, :],
                              max=0.0))
    a = torch.where(tri, (rc[..., :, None, :] * kc[..., None, :, :]
                          * e).sum(-1), 0.0)
    return logc, logb, logc[..., -1:, :], e, a


def _wkv6_shapes(r, k, v, logw, s0, chunk: int, return_states: bool):
    if r.device.type != "meta":
        raise ValueError("_wkv6_shapes takes meta tensors only")
    B, H, T, K = r.shape
    rc, kc, vc, wc = (_chunks(x, chunk) for x in (r, k, v, logw))
    n = rc.shape[2]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    starts = s0.float()[:, :, None].expand(B, H, n, K, v.shape[-1])
    logc, logb, total, _, a = _chunk_terms(rc, kc, wc, tri)
    o = torch.einsum("bhntk,bhnkv->bhntv", rc * torch.exp(logb), starts) \
        + torch.einsum("bhnti,bhniv->bhntv", a, vc)
    ends = starts * torch.exp(total[..., 0, :, None]) + torch.einsum(
        "bhnik,bhniv->bhnkv", kc * torch.exp(total - logc), vc)
    o = o.reshape(B, H, -1, v.shape[-1])[:, :, :T]
    s = ends[:, :, -1]
    if not return_states:
        return o, s
    return o, s, ends[:, :, :-1].permute(2, 0, 1, 3, 4)


def _wkv6_bwd_shapes(r, k, v, logw, s0, do, ds_final, chunk: int, states):
    if r.device.type != "meta":
        raise ValueError("_wkv6_bwd_shapes takes meta tensors only")
    B, H, T, K = r.shape
    V = v.shape[-1]
    rc, kc, vc, wc, gc = (_chunks(x, chunk) for x in (r, k, v, logw, do))
    n = rc.shape[2]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    logc, logb, total, e, a = _chunk_terms(rc, kc, wc, tri)
    decay_k = kc * torch.exp(total - logc)
    s0 = s0.float()[:, :, None]
    if states is None:          # the loop's forward pass over n - 1 chunks
        past = s0 * torch.exp(total[:, :, :-1, 0, :, None]) + torch.einsum(
            "bhnik,bhniv->bhnkv", decay_k[:, :, :-1], vc[:, :, :-1])
        starts = torch.cat([s0, past], dim=2)
    else:
        starts = torch.cat([s0, states.float().permute(1, 2, 0, 3, 4)], 2)
    s = starts[:, :, -1] * torch.exp(total[:, :, -1, 0, :, None]) \
        + torch.einsum("bhik,bhiv->bhkv", decay_k[:, :, -1], vc[:, :, -1])
    ds = torch.zeros_like(s) if ds_final is None else ds_final.float()
    carry = (ds * s).sum(-1)
    ds = ds[:, :, None].expand(B, H, n, K, V)
    da = torch.where(tri, torch.einsum("bhntv,bhniv->bhnti", gc, vc), 0.0)
    dv = torch.einsum("bhnti,bhntv->bhniv", a, gc) + torch.einsum(
        "bhnik,bhnkv->bhniv", decay_k, ds)
    dr = torch.exp(logb) * torch.einsum("bhnkv,bhntv->bhntk", starts, gc) \
        + (da[..., None] * kc[..., None, :, :] * e).sum(4)
    dk = (da[..., None] * rc[..., :, None, :] * e).sum(3) \
        + torch.exp(total - logc) * torch.einsum("bhnkv,bhniv->bhnik", ds,
                                                 vc)
    q, p = rc * dr, kc * dk
    suffix = torch.flip(torch.cumsum(torch.flip(q - p, (3,)), 3), (3,))
    dlogw = carry[:, :, None, None, :] + suffix - q
    carry = carry[:, :, None] + (q - p).sum(3)
    ds = ds * torch.exp(total[..., 0, :, None]) + torch.einsum(
        "bhntk,bhntv->bhnkv", rc * torch.exp(logb), gc)
    dr, dk, dv, dlogw = (g.reshape(B, H, -1, g.shape[-1])[:, :, :T]
                         for g in (dr, dk, dv, dlogw))
    return dr, dk, dv, dlogw, ds[:, :, 0]


# ----------------------------------------------------------------------- #
# The SSD heads' elementwise work around the scan (`csrc/ssd*.cu`)
# ----------------------------------------------------------------------- #
# Shapes: xz (G, n, 2E) holds xs | z of n = B T rows per client, dt_raw
# (G, n, H), bt / ct (G, n, N), conv_w (G, K, E), conv_b / out_norm (G, E),
# dt_b / a_log / d_skip (G, H), conv_tail (G, B, K - 1, E) or None (zeros),
# all in the model's dtype; E = H * head_dim. Arithmetic in f32; values
# are rounded to the model's dtype where the composition rounds them: xh
# (the conv's SiLU output) and u (the heads' output before the gate).
SSD_CONV_K = 4
SSD_NORM_EPS = 1e-5


def _dsilu(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _ssd_conv_in(xz: torch.Tensor, conv_tail, seq_len: int) -> torch.Tensor:
    """The conv's input rows in f32: the tail (or zeros), then xs: (G, B,
    T + K - 1, E)."""
    G, n, E2 = xz.shape
    E = E2 // 2
    xs = xz[..., :E].reshape(G, n // seq_len, seq_len, E).float()
    if conv_tail is None:
        conv_tail = torch.zeros(xs.shape[:-2] + (SSD_CONV_K - 1, E),
                                dtype=xs.dtype, device=xs.device)
    return torch.cat([conv_tail.float(), xs], dim=-2)


def _ssd_pre(xp: torch.Tensor, conv_w: torch.Tensor,
             conv_b: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv before its SiLU: (G, B, T, E) f32, the
    taps summed in order, then the bias."""
    T = xp.shape[-2] - SSD_CONV_K + 1
    w = conv_w.float()[:, None, None]                  # (G, 1, 1, K, E)
    acc = xp[..., 0:T, :] * w[..., 0, :]
    for i in range(1, SSD_CONV_K):
        acc = acc + xp[..., i:i + T, :] * w[..., i, :]
    return acc + conv_b.float()[:, None, None]


def ssd_front_ref(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log,
                  conv_tail, seq_len: int, head_dim: int):
    """The front of the SSD heads, up to the scan's inputs -> (xh (G, n,
    E) model dtype, r (G B, T, H, N) f32, v (G B, T, H, head_dim) f32, k
    (G, n, N) f32, dt (G, n, H) f32, logw (G, n, H) f32):
      xh   = silu(conv_b + sum_i xp[t - K + 1 + i] conv_w[i]), rounded
      dt   = softplus(dt_raw + dt_b) (exact: logaddexp(., 0))
      logw = -dt exp(a_log),  v = xh dt,  r = ct exp(logw),  k = bt.
    The scan reads r and v transposed to (G B, H, T, .), k and logw as
    broadcast views over heads and over the state dim."""
    G, n, E2 = xz.shape
    E, T = E2 // 2, seq_len
    B, H = n // T, E // head_dim
    pre = _ssd_pre(_ssd_conv_in(xz, conv_tail, T), conv_w, conv_b)
    xh = F.silu(pre).to(xz.dtype).reshape(G, n, E)
    u = dt_raw.float() + dt_b.float()[:, None]
    dt = torch.logaddexp(u, torch.zeros((), dtype=u.dtype, device=u.device))
    logw = -dt * torch.exp(a_log.float())[:, None]
    v = xh.float().reshape(G, n, H, head_dim) * dt[..., None]
    r = ct.float()[:, :, None, :] * torch.exp(logw)[..., None]
    return (xh, r.reshape(G * B, T, H, -1), v.reshape(G * B, T, H, head_dim),
            bt.float(), dt, logw)


def _ssd_out(o, xh, bt, ct, dt, d_skip, head_dim: int):
    """u = round(o + (ct . bt) dt xh + d_skip xh), (G, n, E) f32: the
    scan's output with its diagonal and the D skip, rounded to the model's
    dtype; o (G B, T, H, head_dim) f32."""
    G, n, E = xh.shape
    H = E // head_dim
    xf = xh.float().reshape(G, n, H, head_dim)
    cb = (ct.float() * bt.float()).sum(-1)
    o = o.reshape(G, n, H, head_dim) + cb[..., None, None] \
        * (xf * dt[..., None]) + d_skip.float()[:, None, :, None] * xf
    return o.reshape(G, n, E).to(xh.dtype).float()


def ssd_back_ref(o, xh, xz, bt, ct, dt, d_skip, out_norm, head_dim: int):
    """The back of the SSD heads, from the scan's output o (G B, T, H,
    head_dim) f32 -> (y (G, n, E) model dtype, rstd (G, n) f32):
      g = u silu(z),  rstd = (mean_e g^2 + SSD_NORM_EPS)^-1/2,
      y = g rstd (1 + out_norm)
    with u from `_ssd_out`."""
    E = xh.shape[-1]
    g = _ssd_out(o, xh, bt, ct, dt, d_skip, head_dim) \
        * F.silu(xz[..., E:].float())
    rstd = torch.rsqrt(g.square().mean(-1) + SSD_NORM_EPS)
    y = g * rstd[..., None] * (1.0 + out_norm.float()[:, None])
    return y.to(xh.dtype), rstd


def ssd_back_bwd_ref(dy, o, xh, xz, bt, ct, dt, d_skip, out_norm, rstd,
                     head_dim: int):
    """The backward kernel's formulas for `ssd_back_ref`: dy (G, n, E) ->
    (du (G, n, E) f32, the gradient of u and so of o; dz (G, n, E) model
    dtype; p2 = sum over each head's channels of du xh, (G, n, H) f32;
    dout_norm (G, E) f32). With nh = g rstd and dn = dy (1 + out_norm):
      dg = rstd (dn - nh mean_e(dn nh)),  du = dg silu(z),
      dz = dg u silu'(z),  dout_norm = sum_rows dy nh."""
    G, n, E = xh.shape
    H = E // head_dim
    z = xz[..., E:].float()
    u = _ssd_out(o, xh, bt, ct, dt, d_skip, head_dim)
    s = F.silu(z)
    nh = u * s * rstd[..., None]
    dyf = dy.float()
    dn = dyf * (1.0 + out_norm.float()[:, None])
    dg = rstd[..., None] * (dn - nh * (dn * nh).mean(-1, keepdim=True))
    du = dg * s
    p2 = (du.reshape(G, n, H, head_dim)
          * xh.float().reshape(G, n, H, head_dim)).sum(-1)
    return du, (dg * u * _dsilu(z)).to(xz.dtype), p2, (dyf * nh).sum(1)


def ssd_front_bwd_ref(du, dv, dr, dk, dlogw, p2, xz, dt_raw, bt, ct, conv_w,
                      conv_b, dt_b, a_log, d_skip, conv_tail, dt, logw,
                      seq_len: int, head_dim: int):
    """The backward kernel's formulas for `ssd_front_ref` with the
    scan's and the diagonal's gradients folded in: du (G, n, E) and p2
    from `ssd_back_bwd_ref`; dv (G B, H, T, head_dim), dr, dk and dlogw
    (G B, H, T, N) dense from the scan's backward (dk and dlogw of the
    broadcast views, summed here over heads and over the state dim).
    Returns (dxs (G, n, E), ddt_raw (G, n, H), dbt, dct (G, n, N),
    dconv_w, dconv_b, ddt_b, da_log, dd_skip, dconv_tail or None), each in
    its input's dtype. With cb = ct . bt, A = exp(a_log):
      dxh  = (dv + cb du) dt + d_skip du,  dpre = dxh silu'(pre)
      dxp[t - K + 1 + i] += conv_w[i] dpre[t],  dconv_w[i] = sum xp dpre
      dlw  = sum_n dlogw + exp(logw) sum_n dr ct
      ddt  = sum_p dv xh + cb p2 - A dlw,  ddt_raw = ddt sigmoid(dt_raw + dt_b)
      da_log = -sum A dt dlw,  dd_skip = sum p2,  dcb = sum_h dt p2
      dbt  = dcb ct + sum_h dk,  dct = dcb bt + sum_h exp(logw) dr."""
    G, n, E2 = xz.shape
    E, T, K = E2 // 2, seq_len, SSD_CONV_K
    B, H = n // T, E // head_dim
    xp = _ssd_conv_in(xz, conv_tail, T)
    pre = _ssd_pre(xp, conv_w, conv_b)
    xh = F.silu(pre).to(xz.dtype).float().reshape(G, n, H, head_dim)
    heads = lambda t: t.transpose(1, 2).reshape(G, n, H, t.shape[-1])
    dv, dr, dk, dlogw = heads(dv), heads(dr), heads(dk), heads(dlogw)
    duh = du.reshape(G, n, H, head_dim)
    btf, ctf = bt.float(), ct.float()
    # The diagonal's dot and, below, its share of dbt and dct (dcb ct,
    # dcb bt) as matrix products, the dot and the two outer products of its
    # backward, as the composition's einsum and its autograd ran them. Two
    # tests hold this form, not the math: bench/test_counts.py's
    # test_matmul_flops_match_the_flop_counter counts these products as
    # the model's matmul FLOPs, and tests/test_torch_lm_train.py's
    # test_three_train_steps_match_reference[hymba-1.5b] sits near its
    # tolerance, which elementwise forms of the same sums cross by rounding.
    cb = torch.einsum("gtn,gtn->gt", ctf, btf)
    dxh = (dv + cb[..., None, None] * duh) * dt[..., None] \
        + d_skip.float()[:, None, :, None] * duh
    dpre = dxh.reshape(G, B, T, E) * _dsilu(pre)
    w = conv_w.float()
    edge = lambda m: dpre.new_zeros(dpre.shape[:-2] + (m, E))
    dxp = sum(torch.cat([edge(i), dpre * w[:, None, None, i],
                         edge(K - 1 - i)], dim=-2) for i in range(K))
    dconv_w = torch.stack([(xp[..., i:i + T, :] * dpre).sum((1, 2))
                           for i in range(K)], dim=1)
    ew = torch.exp(logw)
    dlw = dlogw.sum(-1) + ew * (dr * ctf[:, :, None, :]).sum(-1)
    A = torch.exp(a_log.float())[:, None]
    ddt_raw = ((dv * xh).sum(-1) + cb[..., None] * p2 - A * dlw) \
        * torch.sigmoid(dt_raw.float() + dt_b.float()[:, None])
    dcb = (dt * p2).sum(-1)[..., None, None]
    outer = lambda t: (dcb @ t[..., None, :])[..., 0, :]
    dbt = outer(ctf) + dk.sum(2)
    dct = outer(btf) + (dr * ew[..., None]).sum(2)
    dtail = None if conv_tail is None else dxp[..., :K - 1, :]
    as_ = lambda t, like: None if t is None else t.to(like.dtype)
    return (dxp[..., K - 1:, :].reshape(G, n, E).to(xz.dtype),
            as_(ddt_raw, dt_raw), as_(dbt, bt), as_(dct, ct),
            as_(dconv_w, conv_w), as_(dpre.sum((1, 2)), conv_b),
            as_(ddt_raw.sum(1), dt_b), as_(-(A * dt * dlw).sum(1), a_log),
            as_(p2.sum(1), d_skip), as_(dtail, conv_tail))
