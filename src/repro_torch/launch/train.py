"""Training launcher: train an --arch for a few AdamW steps.

Port of `repro.launch.train`. Runs on the card unless `--device cpu` is
given (which runs the kernels' plain versions); reduced configs by
default, the published widths with `--full-config` (one H100 holds
full-width hymba-1.5b with its f32 Adam moments at batch 2 x 2048
tokens). Every attention layer runs through the `flash_attention`
kernel and its backward kernel (an enc-dec model's encoder and
cross-attention too), every SSD head through `wkv6` and its backward
kernel. Weights are random, from a seed. Each batch carries zero
prefix embeddings (VLM) and zero frame embeddings (enc-dec) where the
config takes them, as the reference's launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --full-config --batch 2 --seq 2048 --steps 4

Progress is reported through `repro_torch.obs.log_record` — structured
JSON lines on stderr, quiet by default; set REPRO_LOG=1 (or --log) to
see them. Each step runs in a `launch.train_step` span and adds
`--batch * --seq` to the `launch.train_tokens` counter; with tracing or
logging on, each step ends in a device sync (observation only), so the
span and the record's s/step are device-complete.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.models.lm.transformer import count_params, init_params
from repro_torch.obs import count, enabled as obs_enabled
from repro_torch.obs import log_enabled, log_record, set_logging, span
from repro_torch.optim.adam import adam_init
from repro_torch.train.step import make_train_step


def stub_embeds(cfg, batch: int, device) -> dict:
    """The stubbed modality inputs a batch of `cfg` takes, zeros in the
    model's dtype as the reference's launcher gives them: the vision
    tower's "prefix_embeds" (batch, n_prefix_tokens, d) and the audio
    frontend's "enc_embeds" (batch, n_frames, d)."""
    out = {}
    zeros = lambda n: torch.zeros((batch, n, cfg.d_model),
                                  dtype=getattr(torch, cfg.dtype),
                                  device=device)
    if cfg.n_prefix_tokens:
        out["prefix_embeds"] = zeros(cfg.n_prefix_tokens)
    if cfg.encoder is not None:
        out["enc_embeds"] = zeros(cfg.encoder.n_frames)
    return out


def main(argv=None):
    """Train `--steps` steps; returns the `train.done` record (arch,
    steps, per-step losses, s/step and tokens/s over the steps after the
    first, which carries the kernels' build and the allocator's
    warm-up)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=lm_arch_ids())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published widths (one H100)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
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
    log_record("train.start", arch=cfg.name,
               params_m=round(count_params(params) / 1e6, 2),
               steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               device=str(device))
    opt = adam_init(params)
    step = make_train_step(cfg, lr=args.lr, remat=False)
    measure = obs_enabled() or log_enabled()

    rng = np.random.default_rng(0)
    losses, step_s = [], []
    for i in range(args.steps):
        toks = synthetic_token_batch(args.batch, args.seq, cfg.vocab_size,
                                     seed=int(rng.integers(1 << 30)))
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                           device=device)}
        batch.update(stub_embeds(cfg, args.batch, device))
        t0 = time.perf_counter()
        with span("launch.train_step", step=i):
            params, opt, metrics = step(params, opt, batch)
            loss = float(metrics["loss"])         # waits for the step
            if measure and device.type == "cuda":
                torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        count("launch.train_tokens", args.batch * args.seq)
        if i % 10 == 0 or i == args.steps - 1:
            log_record("train.step", step=i, loss=round(loss, 4),
                       s_per_step=round(step_s[-1], 3))
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, params, step=i + 1)
            log_record("train.checkpoint", path=f"{args.ckpt}.npz",
                       step=i + 1)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        log_record("train.checkpoint", path=f"{args.ckpt}.npz",
                   step=args.steps, final=True)
    steady = step_s[1:] or step_s
    s_per_step = sum(steady) / max(len(steady), 1)
    return log_record("train.done", arch=cfg.name, steps=args.steps,
                      losses=losses, s_per_step=s_per_step,
                      tokens_per_s=args.batch * args.seq / s_per_step
                      if s_per_step else None,
                      device=str(device))


if __name__ == "__main__":
    main()
