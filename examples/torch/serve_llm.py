"""End-to-end serving driver: batched prefill + decode on any --arch, on
the card.

The PyTorch port's counterpart of `examples/serve_llm.py`: serves the
reduced variant of an assigned architecture with a batch of synthetic
requests through the port's `prefill` and serve step (attention through
`flash_attention`, rwkv6's time mix through `wkv6`).

  PYTHONPATH=src python examples/torch/serve_llm.py --arch rwkv6-1.6b \
      --tokens 32 [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.device import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.models.lm.transformer import prefill
from repro_torch.train.step import make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main(argv=None, *, params=None) -> dict:
    """Serve one batch and print its lines; returns the generated tokens
    (B, tokens + 1) and the walls. `params` is the weights seam (tests
    carry the reference's weights in with `lm_params_from_jax`); the
    command line never sets it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=lm_arch_ids())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"serving {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size}")
    if params is None:
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    rng = np.random.default_rng(0)
    B = args.batch
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, args.prompt_len)),
        dtype=torch.int64, device=device)
    enc = None
    if cfg.encoder is not None:
        enc = torch.as_tensor(
            rng.normal(size=(B, cfg.encoder.n_frames, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=device)

    max_seq = args.prompt_len + args.tokens + 8
    t0 = time.time()
    logits, cache = prefill(cfg, params, prompt, max_seq, enc_embeds=enc)
    _sync(device)
    prefill_s = time.time() - t0
    print(f"prefill: {B} x {args.prompt_len} tokens in {prefill_s:.2f}s")

    serve = make_serve_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    outs = [tok]
    t0 = time.time()
    for _ in range(args.tokens):
        tok, _, cache = serve(params, tok, cache)
        outs.append(tok)
    _sync(device)
    dt = time.time() - t0
    gen = torch.cat(outs, dim=1).cpu().numpy()
    print(f"decode : {args.tokens} steps x batch {B} in {dt:.2f}s "
          f"({args.tokens * B / dt:.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  request {b}: {gen[b][:16]} ...")
    return {"arch": cfg.name, "tokens": gen, "prefill_s": prefill_s,
            "decode_s": dt, "device": str(device)}


if __name__ == "__main__":
    main()
