"""Serving launcher: batched request loop over an --arch.

Port of `repro.launch.serve`. A minimal production-shaped server: a
request queue, one prefill per arrival batch, then lock-step batched
greedy decode (the KV cache is slot-stable). The prefill runs every
attention layer through the `flash_attention` kernel (an enc-dec model's
encoder and cross-attention too: the encoder runs once a batch, over
zero frame embeddings as in the reference's launcher, and prefill caches
the cross K/V that every decode step reads) and every SSD head through
the `wkv6` kernel; decode is plain torch. Runs on the card
unless `--device cpu` is given; reduced configs by default, the full
published widths with `--full-config` (random weights from a seed).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --requests 8 --batch 4 --max-new 32 --device cpu

Progress is reported through `repro_torch.obs.log_record` — structured
JSON lines on stderr, quiet by default; set REPRO_LOG=1 (or --log) to
see them. With tracing or logging on, the prefill and every decode step
end in a device sync (`torch.cuda.synchronize()`; observation only, the
values are unchanged), so the `launch.prefill` span and the per-token
latencies are device-complete, and the final record carries tokens/s
and p50/p99 latency. `launch.decode_tokens` / `launch.requests_served`
counters land in the tracer.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.device import resolve_device
from repro_torch.models.lm.transformer import init_params, prefill
from repro_torch.obs import count, enabled as obs_enabled
from repro_torch.obs import log_enabled, log_record, set_logging, span
from repro_torch.train.step import make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_batch(cfg, params, prompts: torch.Tensor, max_new: int,
                enc=None):
    """Prefill one arrival batch and decode all requests lock-step.

    Returns (tokens (B, max_new + 1), per_step_latency_s, the logits of
    the prefill and of every decode step (max_new + 1, B, V)); the
    latency list is empty unless obs tracing or logging is on (measuring
    it requires a per-step device sync, which would otherwise perturb
    pipelining).
    """
    B, Lp = prompts.shape
    max_seq = Lp + max_new + 8
    measure = obs_enabled() or log_enabled()
    with span("launch.prefill", batch=B, prompt_len=Lp):
        logits, cache = prefill(cfg, params, prompts, max_seq,
                                enc_embeds=enc)
        if measure:
            _sync(prompts.device)
    step = make_serve_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out, all_logits = [tok], [logits]
    lat_s: list[float] = []
    with span("launch.decode", batch=B, max_new=max_new):
        for _ in range(max_new):
            t0 = time.perf_counter()
            tok, logits, cache = step(params, tok, cache)
            if measure:
                _sync(prompts.device)
                lat_s.append(time.perf_counter() - t0)
            out.append(tok)
            all_logits.append(logits)
    count("launch.decode_tokens", B * max_new)
    return torch.cat(out, dim=1), lat_s, torch.stack(all_logits)


def _quantile_ms(lat_s: list[float], q: float) -> float:
    """Nearest-rank quantile of a latency list, in milliseconds."""
    ordered = sorted(lat_s)
    return round(ordered[int(q * (len(ordered) - 1))] * 1e3, 2)


def main(argv=None):
    """Serve `--requests` random prompts; returns (the `serve.done`
    record, the generated tokens (requests, max_new + 1), the last
    decode step's logits (requests, V))."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=lm_arch_ids())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--log", action="store_true",
                    help="emit structured progress records on stderr "
                         "(same as REPRO_LOG=1)")
    args = ap.parse_args(argv)
    if args.log:
        set_logging(True)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    log_record("serve.start", arch=cfg.name, requests=args.requests,
               batch=args.batch, prompt_len=args.prompt_len,
               max_new=args.max_new, device=str(device))

    # Request queue -> arrival batches of size --batch.
    queue = [rng.integers(0, cfg.vocab_size, args.prompt_len, dtype=np.int32)
             for _ in range(args.requests)]
    served = 0
    lat_all: list[float] = []
    tokens, last_logits = [], []
    t0 = time.perf_counter()
    while queue:
        batch = queue[:args.batch]
        queue = queue[args.batch:]
        prompts = torch.as_tensor(np.stack(batch), dtype=torch.int64,
                                  device=device)
        enc = None
        if cfg.encoder is not None:          # the stubbed audio frontend
            enc = torch.zeros((prompts.shape[0], cfg.encoder.n_frames,
                               cfg.d_model), dtype=getattr(torch, cfg.dtype),
                              device=device)
        with span("launch.serve_batch", batch=prompts.shape[0]):
            gen, lat_s, logits = serve_batch(cfg, params, prompts,
                                             args.max_new, enc=enc)
        served += prompts.shape[0]
        count("launch.requests_served", prompts.shape[0])
        lat_all.extend(lat_s)
        tokens.append(gen)
        last_logits.append(logits[-1])
        log_record("serve.batch", batch=int(prompts.shape[0]),
                   tokens_per_request=int(gen.shape[1]),
                   served=served, total=args.requests)
    _sync(device)
    dt = time.perf_counter() - t0
    final = {"requests": served, "max_new": args.max_new,
             "wall_s": round(dt, 2),
             "tokens_per_s": round(served * args.max_new / dt, 1)}
    if lat_all:
        final["decode_p50_ms"] = _quantile_ms(lat_all, 0.50)
        final["decode_p99_ms"] = _quantile_ms(lat_all, 0.99)
    done = log_record("serve.done", **final)
    return done, torch.cat(tokens), torch.cat(last_logits)


if __name__ == "__main__":
    main()
