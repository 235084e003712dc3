"""Top-k routed mixture-of-experts with sort-based capacity dispatch.

Port of `repro.models.lm.moe` (the row-local `apply_moe`; the
expert-parallel `apply_moe_ep` waits for the multi-device slice). The
dispatch is GShard-style without the (T, E, C) one-hot tensor: token ->
expert assignments are sorted (a stable sort, as `jnp.argsort`, so which
tokens overflow a full expert is the reference's), positions within each
expert group come from cumulative counts, and tokens scatter into an
(E, C, d) buffer that feeds batched per-expert products (`torch.matmul`
over the expert axis; the reference's einsums, outside any kernel).
Overflowing tokens go to one extra slot that is thrown away; underfull
slots are zero. Each kept slot is written once, so the buffer is the
reference's exactly.

Every function here takes leading axes: `_route` a client axis, and
`_dispatch_tokens` / `_combine_tokens` a row axis R, each row its own
dispatch. `apply_moe_stacked` runs a stack of G clients (every leaf of
`p` with a leading (G,) axis, x (G, B*S, d)): rows of S >= 64 tokens
dispatch row-locally (R = G*B, C = round(S K cf / E) per row), shorter
ones (decode, S = 1) in one dispatch per client over its B*S tokens.
The aux losses (switch load balance, router z) are per client, over
that client's own tokens: (G,). `apply_moe` is its G = 1 view, with the
reference's 0-d aux.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.lm.config import MoEConfig
from repro_torch.models.lm.layers import apply_mlp, dense_init, init_mlp
from repro_torch.models.lm.params import map_tree

# Rows shorter than this use one global dispatch (decode: S == 1).
_ROW_DISPATCH_MIN_S = 64


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             mlp_kind: str, lead: tuple[int, ...] = (), device=None,
             dtype=torch.float32) -> dict:
    device = resolve_device(device)
    kw = dict(lead=lead, device=device, dtype=dtype)
    e, ff = cfg.n_experts, cfg.d_ff_expert
    gated = mlp_kind in ("swiglu", "geglu")
    p = {
        "router": dense_init(generator, (d_model, e), scale=d_model ** -0.5,
                             **kw),
        "w1": dense_init(generator, (e, d_model, ff), **kw),
        "w2": dense_init(generator, (e, ff, d_model), **kw),
    }
    if gated:
        p["w3"] = dense_init(generator, (e, d_model, ff), **kw)
    if cfg.n_shared:
        p["shared"] = init_mlp(generator, d_model, ff * cfg.n_shared, gated,
                               **kw)
    return p


def _expert_ffn(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (..., E, C, d) -> (..., E, C, d), batched over experts (and any
    leading axes the weights share)."""
    h = x @ p["w1"]
    if kind == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif kind == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w2"]


def _route(p: dict, xf: torch.Tensor, cfg: MoEConfig):
    """Router + aux losses, in f32. xf: (..., T, d), p["router"] (...,
    d, E). Returns (gates (..., T, K), expert ids (..., T, K), aux: each
    term (...,))."""
    E, K = cfg.n_experts, cfg.top_k
    T = xf.shape[-2]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (..., T, E)
    # lax.top_k: the K largest, the lower index first on ties.
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[..., :K], ids[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(-2)                                      # (..., E)
    flat = expert_ids.reshape(expert_ids.shape[:-2] + (T * K,))
    ce = torch.zeros(me.shape, dtype=torch.float32, device=xf.device) \
        .scatter_add_(-1, flat, torch.ones(flat.shape, device=xf.device)) \
        / (T * K)
    aux = {
        "load_balance": E * torch.sum(me * ce, -1) * cfg.router_aux_coef,
        "router_z": 1e-4 * torch.mean(
            torch.square(torch.logsumexp(logits, dim=-1)), -1),
    }
    return gate_vals, expert_ids, aux


def _dispatch_tokens(xf: torch.Tensor, gate_vals: torch.Tensor,
                     expert_ids: torch.Tensor, E: int, C: int):
    """Sort-based capacity dispatch, one per row. xf (R, T, d), gates and
    ids (R, T, K) -> buffer (R, E, C, d) plus the combine metadata
    (slot, token, gate, keep), each (R, T*K) in sorted order; a dropped
    assignment's slot is E*C."""
    R, T, d = xf.shape
    K = expert_ids.shape[-1]
    dev = xf.device
    flat_e = expert_ids.reshape(R, T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate_vals.reshape(R, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, st, sg = flat_e.gather(1, order), flat_t[order], \
        flat_g.gather(1, order)
    counts = torch.zeros((R, E), dtype=torch.int64, device=dev) \
        .scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 1) - counts               # (R, E)
    pos_in_e = torch.arange(T * K, device=dev) - offsets.gather(1, se)
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)       # drop slot
    rows = torch.arange(R, device=dev)[:, None]
    buf = torch.zeros((R * (E * C + 1), d), dtype=xf.dtype, device=dev)
    buf[(rows * (E * C + 1) + slot).reshape(-1)] = \
        xf.reshape(R * T, d)[(rows * T + st).reshape(-1)]
    buf = buf.view(R, E * C + 1, d)[:, :-1].reshape(R, E, C, d)
    return buf, (slot, st, sg, keep)


def _combine_tokens(y_slots: torch.Tensor, meta, T: int,
                    dtype) -> torch.Tensor:
    """y_slots (R, E*C, d) -> (R, T, d): each token the gate-weighted sum
    of its kept slots' outputs."""
    slot, st, sg, keep = meta
    R, EC, d = y_slots.shape
    rows = torch.arange(R, device=y_slots.device)[:, None]
    picked = y_slots.reshape(R * EC, d)[
        (rows * EC + torch.clamp(slot, max=EC - 1)).reshape(-1)]
    contrib = picked * (sg * keep).reshape(-1, 1).to(dtype)
    y = torch.zeros((R * T, d), dtype=dtype, device=y_slots.device)
    y.index_add_(0, (rows * T + st).reshape(-1), contrib)
    return y.view(R, T, d)


def apply_moe_stacked(p: dict, x: torch.Tensor, cfg: MoEConfig,
                      mlp_kind: str, seq_len: int):
    """x (G, B*S, d) of G clients, S = seq_len, p's leaves (G, ...) ->
    (y (G, B*S, d), aux {"load_balance", "router_z"}, each (G,))."""
    G, n, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    S = seq_len
    gate_vals, expert_ids, aux = _route(p, x, cfg)
    # Row-local dispatch for full sequences, one per client below that.
    R, T = (G * (n // S), S) if S >= _ROW_DISPATCH_MIN_S else (G, n)
    C = int(max(1, round(T * K * cfg.capacity_factor / E)))
    buf, meta = _dispatch_tokens(x.reshape(R, T, d),
                                 gate_vals.reshape(R, T, K),
                                 expert_ids.reshape(R, T, K), E, C)
    # A client's rows go through its own experts together: (G, E, rows*C, d).
    rg = R // G
    h = buf.view(G, rg, E, C, d).transpose(1, 2).reshape(G, E, rg * C, d)
    h = _expert_ffn(p, h, mlp_kind)
    h = h.view(G, E, rg, C, d).transpose(1, 2).reshape(R, E * C, d)
    y = _combine_tokens(h, meta, T, x.dtype).reshape(G, n, d)
    if cfg.n_shared:
        y = y + apply_mlp(p["shared"], x, mlp_kind)
    return y, aux


def apply_moe(p: dict, x: torch.Tensor, cfg: MoEConfig, mlp_kind: str
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux with 0-d terms): routed top-k + optional
    shared experts, one model (the G = 1 view of `apply_moe_stacked`)."""
    B, S, d = x.shape
    y, aux = apply_moe_stacked(map_tree(lambda t: t[None], p),
                               x.reshape(1, B * S, d), cfg, mlp_kind, S)
    return y.view(B, S, d), {k: v[0] for k, v in aux.items()}
