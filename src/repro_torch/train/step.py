"""Training / prefill / serve steps for the LM architectures.

Port of `repro.train.step`. `make_train_step(cfg)` builds the training
step (AdamW on `lm_loss`); the same loss, over a stack of clients
(`client_lm_losses`), is the LM workloads' client loss in the
constellation (`repro_torch.core.workload.lm_workload`). The reference
jits the returned functions; here they run eagerly, and gradients come
from autograd through the port's kernels (`flash_attention` and `wkv6`
have backward kernels).

Decode shapes run `serve_step` — one token against a KV cache — and
prefill shapes run `prefill_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.params import map_tree
from repro_torch.models.lm.transformer import (
    decode_step,
    forward_train,
    forward_train_stacked,
    prefill,
)
from repro_torch.optim.adam import adam_init, adam_update

Batch = dict[str, Any]


def _ce_tokens(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy in f32, as the reference's `_ce` computes
    it: the max (without gradient) taken out, log-sum-exp minus the
    label's shifted logit (a gather, where the reference multiplies by a
    one-hot to keep a vocab-sharded axis elementwise)."""
    l32 = logits.float()
    shifted = l32 - l32.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(-1))
    picked = shifted.gather(-1, labels[..., None].long())[..., 0]
    return lse - picked


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (the reference's `_ce`)."""
    return _ce_tokens(logits, labels).mean()


# Weight of the MTP head's next-next-token CE in the loss (the
# reference's).
MTP_WEIGHT = 0.3


def lm_loss(cfg: ModelConfig, params, batch: Batch):
    """Next-token CE + the MoE aux term (zero without MoE layers) + 0.3 x
    the MTP head's next-next-token CE where the config has one.

    batch: {"tokens": (B, S) integer, optional "prefix_embeds" (B, P, d),
    optional "enc_embeds" (B, F, d)}; the prefix positions carry no loss.
    Returns (loss, metrics) with the reference's metric names ("ce",
    "moe_aux", "mtp" with the MTP head, "loss")."""
    tokens = batch["tokens"]
    logits, aux = forward_train(cfg, params, tokens,
                                prefix_embeds=batch.get("prefix_embeds"),
                                enc_embeds=batch.get("enc_embeds"))
    P = logits.shape[1] - tokens.shape[1]          # prefix length
    loss = _ce(logits[:, P:-1], tokens[:, 1:])
    metrics = {"ce": loss}
    loss = loss + aux["moe_aux"]
    metrics["moe_aux"] = aux["moe_aux"]
    if "mtp_logits" in aux:
        mtp = _ce(aux["mtp_logits"][:, P:-2], tokens[:, 2:])
        loss = loss + MTP_WEIGHT * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def client_lm_losses(cfg: ModelConfig, params, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """`lm_loss` of each client of a stack at once: params' leaves (C,
    ...), tokens (C, B, S) -> (C,) losses (one forward for the stack)."""
    logits, aux = forward_train_stacked(cfg, params, tokens)
    loss = _ce_tokens(logits[:, :, :-1], tokens[:, :, 1:]).mean((1, 2)) \
        + aux["moe_aux"]
    if "mtp_logits" in aux:
        loss = loss + MTP_WEIGHT * _ce_tokens(
            aux["mtp_logits"][:, :, :-2], tokens[:, :, 2:]).mean((1, 2))
    return loss


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    weight_decay: float = 0.0, remat: bool = True,
                    replicate_weights: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    `remat` recomputes each layer in the backward (`torch.utils.
    checkpoint`), the reference's per-layer `jax.checkpoint`.
    `replicate_weights` is the reference's sharding hint: DTensor params
    (the dry run's) are gathered to `Replicate()` once at the step's start
    and the loss differentiated through the gather, so each gradient
    comes back in its param's placements; on plain tensors there is
    nothing to gather, and it changes nothing. Params and the optimizer
    state are updated in place (`adam_update`) and returned.
    """
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)

    def train_step(params, opt_state, batch: Batch):
        leaves: list[torch.Tensor] = []
        map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
        try:
            model = map_tree(_replicated, params) if replicate_weights \
                else params
            loss, metrics = lm_loss(cfg, model, batch)
            grads = iter(torch.autograd.grad(loss, leaves))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = map_tree(lambda p: _laid_out_as(next(grads), p), params)
        params, opt_state = adam_update(params, grads, opt_state, lr=lr,
                                        weight_decay=weight_decay)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its param's placements (the reference's
    gradient takes its param's sharding): one redistribution a leaf, so
    the optimizer's ops need none. A plain gradient as it is."""
    if not isinstance(g, DTensor) or tuple(g.placements) == \
            tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _replicated(p: torch.Tensor) -> torch.Tensor:
    if not isinstance(p, DTensor):
        return p
    return p.redistribute(p.device_mesh,
                          [Replicate()] * p.device_mesh.ndim)


def make_optimizer_state(params):
    return adam_init(params)


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch: Batch):
        return prefill(cfg, params, batch["tokens"], max_seq,
                       prefix_embeds=batch.get("prefix_embeds"),
                       enc_embeds=batch.get("enc_embeds"))
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy-sample the next token for a whole batch
    (`argmax` takes the first index on ties, as `jnp.argmax` does)."""
    def serve_step(params, token: torch.Tensor, cache):
        logits, cache = decode_step(cfg, params, token, cache)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, cache
    return serve_step
