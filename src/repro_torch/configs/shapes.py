"""The four assigned input shapes + per-arch input_specs().

Port of `repro.configs.shapes`. Decode shapes (`decode_32k`,
`long_500k`) run `serve_step` — ONE token against a KV cache of seq_len
— not train_step. `long_500k` is only eligible for sub-quadratic archs
(config.supports_long_context); dense archs get an explicitly-flagged
sliding-window variant; whisper is the single documented skip.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# Beyond-paper long-context variant: dense/MoE archs without native
# windowed attention get this sliding window for long_500k only.
LONGCTX_WINDOW = 8192


def longctx_variant(cfg):
    """Return (cfg', note) adjusted for long_500k, or (None, reason)."""
    if cfg.encoder is not None:
        return None, ("skip: enc-dec full-attention audio model; 500k-token "
                      "decode has no audio analogue (DESIGN.md)")
    if cfg.supports_long_context:
        return cfg, "native (SSM state / sliding window)"
    cfg2 = dataclasses.replace(cfg, sliding_window=LONGCTX_WINDOW)
    return cfg2, f"beyond-paper SWA variant (window={LONGCTX_WINDOW})"


def input_specs(cfg, shape: InputShape) -> dict:
    """`meta` tensors standing in for every model input (no allocation),
    with the reference's shapes and dtypes (tokens int32).

    For VLM/audio the stub modality frontend supplies embeddings of the
    right shape; text token count shrinks so total positions == seq_len.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    sds = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        n_text = S
        if cfg.n_prefix_tokens:
            n_text = S - cfg.n_prefix_tokens
            batch["prefix_embeds"] = sds((B, cfg.n_prefix_tokens,
                                          cfg.d_model), dt)
        batch["tokens"] = sds((B, n_text), torch.int32)
        if cfg.encoder is not None:
            batch["enc_embeds"] = sds((B, cfg.encoder.n_frames, cfg.d_model),
                                      dt)
        return batch
    # decode: one token; the cache spec is built separately.
    return {"tokens": sds((B, 1), torch.int32)}
