"""Prefill and serve steps for the LM architectures.

Port of `repro.train.step`'s two serving-step factories; the training step
(`make_train_step`, the loss, the optimizer) waits for the training
slice (ROADMAP queue item 'LM training with backward'). The reference
jits the returned functions; here they run eagerly.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.transformer import decode_step, prefill

Batch = dict[str, Any]


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
