#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (`src/repro_torch`, never `jax` or `repro`) on the card:

  card       the card's name and power limit (nvidia-smi), torch / CUDA /
             nvcc versions, the kernels' build time (from the sources in
             this checkout), ptxas's registers and spills per kernel and,
             from `cuobjdump -sass`, its tensor-core (HGMMA/HMMA) and
             asynchronous-copy (UTMALDG/LDGSTS) instructions; fails if a
             bf16 flash_attention kernel, or one of the bf16
             flash_attention_bwd dq and dk/dv kernels ((D, Dv) = (64,
             64), (128, 128), (256, 256), (192, 128)), has no
             tensor-core instruction;
  kernels    every CUDA kernel of the main path against its plain PyTorch
             version on the same inputs, in f32 (rtol = atol = 2e-5) and
             bf16 (2e-2), the tolerances of tests/test_kernels.py, with
             device times (CUDA events, median over 100 launches queued
             behind a device sleep so host enqueue time is not counted),
             the byte/flop bound, and a one-call PyTorch yardstick where
             one computes the same function; the floor of an empty launch
             timed the same way (`floor_ms`) and, for the simulator's
             kernels, the time with the L2 evicted before each launch
             (`ms_cold`), the mean time of a launch among 100 run back
             to back with no event between them (`ms_back_to_back`, and
             `floor_back_to_back_ms` for the empty launch) and the host
             time of one wrapper call (`host_us`); the batched sweep's
             extended forms at 32 scenarios x 10 clients of femnist_cnn
             (prox_sgd with per-row mu and grouped or per-client anchors,
             fedagg over a scenario axis, plain and delta); fedagg in
             its plain, delta and partial forms (the partial form is a
             mesh rank's weighted deltas, beside one `addmv`);
  main_path  ConstellationSim.run() for all 8 Table-1 algorithms on the
             paper's largest cell (100 satellites, 13 stations), with the
             kernels' launch counters zeroed just before and read just
             after;
  mesh_path  the same 8 runs with execution="mesh" on a one-rank process
             group whose CUDA backend is NCCL (`sharding.default_group`),
             launch and collective counters zeroed just before and read
             just after: RoundRecords identical to main_path's, final
             params within 1e-5 (one rank rounds as the host path: the
             gap is reported), prox_sgd launches equal to main_path's,
             one fedagg launch (the plain form for the synchronous
             algorithms, the partial form for fedbuff) and two
             all-reduces a round; for fedavg, fedprox and fedbuff every
             round's params against a host run's (1e-5); walls beside
             main_path's;
  where_time_goes  fedprox for 5 rounds on the same cell: host wall
             clock, per-span walls (repro_torch.obs) and, from
             torch.profiler, the device's busy time, idle share and
             kernel time by name;
  cpu_vs_card  fedprox on a small cell on the card and on the CPU with
             the same access windows, init params and minibatch draws,
             through the host path and through the mesh path (NCCL on
             the card, gloo on the CPU): RoundRecords identical, final
             params within 1e-4.
  comms_path ConstellationSim.run() on the main-path cell for the ISL
             algorithms (fedavg_intracc_isl, fedprox_intracc_isl; ISL
             windows computed on the card), the connectivity-aware ones
             (fedspace, ground_assisted, fedprox_sparse), fedprox with each
             lossy uplink codec (quant_int8, quant_fp8, topk_sparse) and
             fedprox_intracc_isl priced by a LinkBudget; launch counters
             zeroed before and read after each run; each run needs both
             kernels launched, finite params, >= 10 rounds, and each ISL
             run at least one relayed return;
  path_shapes  every kernel against its plain version (same
             tolerances) at every distinct shape the main, comms, CNN,
             batched, serving, LM constellation, LM training and examples
             paths launched it with (recorded while those ran: partial-visit
             and buffered flushes, sparse rounds, per-row mu, grouped
             anchors, the scenario axis, the LM layouts' P; for the LM
             kernels each tensor's shape, strides and offset, so the
             model's transposed and broadcast views are replayed as
             they were passed; for the five SSD kernels, forward and
             backward, each client stack, length, weight layout (the
             per-client strides) and conv tail the model passed, at
             1e-4 of each output's scale in f32, 2e-2 in bf16); run
             after lm_train;
  comms_scale the 1,024-satellite plan of benchmarks/bench_scale.py
             (Walker-Star 32 x 32, cross-plane grid with 2 seam
             candidates, 13 stations, 1 day): access and ISL windows on
             the card, the contact plan with its geometry cache, its
             LinkBudget re-rating, and every satellite routed at t = 0
             (3 hops) under both pricings, with each stage's wall; the
             card's ISL grid against the CPU's, where every differing
             sample must be a threshold tie;
  comms_cpu_vs_card  fedprox_intracc_isl and fedprox with each lossy
             codec (int8, fp8, top-k) on a dense 10-satellite plane on the
             card and on the CPU with the same windows, init params,
             minibatch draws and codec uniforms: RoundRecords identical,
             ISL params within 1e-4, each codec run within the bounds
             derived at CODEC_BOUNDS; the fp8 round trip's log2 ties;
  cnn_path   the paper's CNN (femnist_cnn) through ConstellationSim on the
             main-path cell (fedavg, fedprox, fedbuff, 10 rounds), launch
             counters zeroed before and read after each run; card vs CPU
             on c2s2/g1: identical RoundRecords, one local step within
             1e-4, the trained run's gap beside a one-ulp envelope;
  batched_sweep  (a) the Table-1 grid (8 algorithms x 4 x 4 x 6 = 768
             scenarios) as one timing-only BatchedSweep (7 days, 10
             rounds), every 32nd cell held to the loop path bitwise;
             (b) 32 scenarios trained through BatchedSweep on femnist_cnn
             for 5 rounds (one prox_sgd launch a local step, one fedagg a
             round, counted) with device busy time and idle share, then
             through the loop path (identical records, params and curves
             within 1e-4);
             (c) a fedavg/fedprox/fedbuff batch on the card and the CPU.
  lm_kernels flash_attention and wkv6 against their plain versions at
             hymba-1.5b's serving shapes (wkv6 also in the SSD heads'
             broadcast layout), at rwkv6-1.6b's (K = V = 64 on the time
             mix's transposed views, the fixed build and the generic one)
             and grok-1's (bf16, 48 heads on 8 of 128, softcap 30; SDPA
             without softcap beside it), at MLA's value head dim Dv below
             D (deepseek-v3 serving: bf16, 4 x 128 heads x 2048 of
             (192, 128); lm_moe_tiny's f32 (96, 64) launch; SDPA and the
             backend it picks beside them), at whisper-medium's (the
             encoder's bidirectional 16 heads of 64 over 1,500 frames, and
             the cross-attention's 224 queries against 1,500 keys of their
             own length) and llava-next-mistral-7b's (4,928 positions in a
             4,096 window, 32 heads on 8 of 128), and in every mask variant on
             both flash kernels (flash 3e-5 in f32; in bf16 rtol 8e-3 +
             atol 1e-3, about one bf16 rounding step, since both sides
             round one f32 result; wkv6 2e-4), with device times, bounds
             and, for flash, scaled_dot_product_attention as the
             yardstick;
  serve      full-width hymba-1.5b (bf16, random weights from a seed):
             one batch of `serve.serve_batch` plain (wall) and under
             torch.profiler (with every launch of the port's kernels by
             kernel), then `repro_torch.launch.serve.main` with
             8 requests, batch 4, 2048-token prompts (past the 1024
             window: the ring cache rolls), 32 new tokens, launch
             counters zeroed just before and read just after;
  serve_rwkv full-width rwkv6-1.6b (24 layers, d 2048, 32 heads of 64,
             bf16, random weights): a profiled batch, then `serve.main`
             as for hymba-1.5b: 24 wkv6 launches a prefill batch;
  serve_moe  grok-1 at full width with its depth cut to 2 of 64 layers
             (the whole model does not fit one card): one batch of 4 x
             2048 prompt tokens and 32 new through `serve.serve_batch`,
             2 flash_attention launches a prefill, routed experts
             row-local in prefill and global in decode; a profiled batch;
  serve_mla  deepseek-v3 at full width with its depth cut to one dense
             and one MoE MLA layer (14,870,813,696 params, 29.7 GB in
             bf16), served as serve_moe: 2 flash_attention launches at
             (D, Dv) = (192, 128) a prefill, the absorbed decode against
             the (c_kv, k_rope) cache (its bytes a token a layer beside an
             expanded 128-head k/v cache's); a profiled batch;
  serve_audio  whisper-medium at full width (757,877,760 params): 8
             requests of 1,500 random frames and 224 prompt tokens in
             batches of 4, 32 new tokens, through `serve.serve_batch`
             (`_serve_full`): 72 flash_attention launches a prefill
             (encoder, self, cross), prefill and decode times, tokens/s,
             peak memory, the decode cache; the traced run written with
             `obs.write_chrome_trace` and read back; a profiled batch;
  serve_vlm  llava-next-mistral-7b at full width (7,241,732,096 params,
             14.5 GB bf16): 8 requests of 2,880 random prefix embeddings
             and 2,048 text tokens, 32 new, through `init_decode_cache(...,
             prompt=, prefix_embeds=)` and `make_serve_step`, as
             serve_audio: 32 flash_attention launches a prefill, the
             4,096-slot window cache;
  serve_cpu_vs_card  reduced hymba-1.5b, gemma-2b, rwkv6-1.6b, grok-1,
             whisper-medium, llava-next-mistral-7b (seeded random frames
             and prefix embeddings) and deepseek-v3 (f32) from the same
             weights on the card and on the CPU, 160-token prompts:
             identical greedy tokens, logits within 1e-4.
  lm_fl      ConstellationSim.run() for fedavg and fedprox on the LM
             workloads lm_tiny, lm_hybrid_tiny, lm_rwkv6_tiny and
             lm_moe_tiny (c2s2/g1, 2 days, 3
             rounds), launch counters zeroed before and read after each
             run: exactly one prox_sgd launch a local step, one fedagg a
             round, and per attention layer one flash_attention launch a
             local step and an evaluation and one flash_attention_bwd a
             local step for the whole client stack (wkv6 / wkv6_bwd
             likewise for the SSD heads and the RWKV6 time mixes, and
             each SSD kernel per SSD layer: forward a local step and an
             evaluation, backward a local step); finite params and
             accuracy;
  lm_pricing every published LM at full width priced as a constellation
             client: `lm_workload(get_config(arch))` for all 10 archs
             (layout from shapes on `meta`: deepseek-v3's 671,953,083,392
             params allocate nothing; the wire at the config dtype's
             width), timing-only ConstellationSim runs of fedavg_sched and
             fedbuff (at most 50 rounds, 30 days) on the main path's cell
             on the card and on the CPU with one AccessWindows computed
             on the card: RoundRecords identical, no kernel launched; per
             arch n_params, model MB, transfer s, rounds, mean round h and
             total days;
  examples   the four examples of examples/torch/ through their `main`
             on the card at their defaults, launch counters zeroed just
             before and read just after each: quickstart (prox_sgd and
             fedagg; accuracy climbing), constellation_llm with
             --execution host and mesh (flash_attention and its
             backward, prox_sgd, fedagg; the mesh run's records those of
             the host run, accuracy within 1e-5), serve_llm with gemma-2b
             (flash_attention) and rwkv6-1.6b (wkv6), constellation_sweep
             at 60 rounds (20 if the phase has used half its 60 s by
             then); then `ops.fedagg_pytree` (one launch) and
             `ops.prox_sgd_pytree` (one launch a leaf) on the reduced
             gemma-2b's tree on the card against their plain versions on
             CPU copies (f32 2e-5, bf16 2e-2); every launch shape replayed
             by path_shapes;
  lm_train_kernels  the two backward kernels against their plain
             backward (f32 rtol = atol = 2e-5, bf16 rtol 8e-3 + atol
             1e-3 as the forward; wkv6's dlogw
             beside the scale of the terms its suffix sum adds), each fed
             the forward's saved statistics (flash's lse, wkv6's chunk
             states), at the LM cell's shapes, at full-width hymba-1.5b
             (bf16 attention windowed and full causal, the SSD heads' f32
             scan) and at rwkv6-1.6b's K = V = 64 (dense, its training
             step's views, lm_rwkv6_tiny's), two launches giving
             the same bits, with device times, bounds and, for flash, the
             backward of scaled_dot_product_attention as the yardstick and
             the bf16 error with P and dS rounded once (no hi + lo); the
             f32 flash backward at MLA's (96, 64) (lm_moe_tiny) and
             (192, 128); the D = 32 forward (lm_tiny); the bf16
             backward at whisper-medium's training shapes (the encoder's
             1,500 frames, the cross-attention's 448 queries against 1,500
             keys) and at deepseek-v3's (`mla_train`: 2 x 128 heads x
             2,048 of (192, 128), causal); the SSD heads' five kernels
             against their plain versions kernel by kernel (1e-4 of each
             output's scale in f32, 2e-2 in bf16) at the benchmark cell's
             step (hymba-1.5b, bf16, 4 x 2048), at T = 200 in f32, at
             lm_hybrid_tiny's width as lm_fl stacks its 4 clients, and
             for 3 clients with a conv tail, two launches giving the same
             bits, with device times (the conv's backward and the
             weights' reduction, one call, split by kernel name in a
             device profile), bounds by bytes, the plain versions' times
             and the PyTorch composition's they replace;
  lm_train   `repro_torch.launch.train.main` on full-width hymba-1.5b,
             then rwkv6-1.6b (`lm_train_rwkv`) (bf16, batch 2 x 2048) and
             whisper-medium (`lm_train_audio`: batch 4 x 448 text tokens,
             1,500 zero frames), and the launcher's loop on llava at every
             published width with its depth cut to 4 of 32 layers
             (`lm_train_vlm`: 1,134,596,096 params, batch 2 x (2,880 zero
             prefix embeddings + 2,048 text tokens)) (4 AdamW steps at the
             launcher's lr), launch counters zeroed
             just before and read just after: a launch a layer a step of
             each LM kernel the model runs (hymba: 32 of each of
             flash_attention, flash_attention_bwd, wkv6, wkv6_bwd and the
             five SSD kernels;
             rwkv6: 24 of wkv6_bwd and 30 of wkv6, its first 6 layers
             recomputed in the backward; whisper: 72 of
             flash_attention and its backward; llava: 4), finite losses;
             s/step, tokens/s, peak device memory; then 4 steps of the
             same configuration on one fixed batch (one of them under
             torch.profiler: idle share, time by kernel), whose loss
             must fall by more than 3x the spread of the initial
             weights' loss over 4 other batches;
  lm_train_mla  the launcher's loop on deepseek-v3 at every published
             width (d 7168, 128 MLA heads of (192, 128), q / kv latents
             of 1536 / 512, d_ff 18,432, vocab 129,280, untied head and
             the MTP head; bf16) with its depth cut to its 3 dense layers
             (4,530,494,464 params: with f32 Adam moments no routed layer
             fits one card), batch 2 x 2048, as lm_train: 3
             flash_attention and 3 flash_attention_bwd launches a step,
             finite losses, the fixed batch's loss falling by more than
             3 spreads, peak memory, the profiled step's time by kernel;
             then one step from the same weights and batch with and
             without remat: the losses, the updated params within one
             bf16 rounding an element of each other, 6 forward launches
             with remat against 3, both peak memories;
  mesh_lm_round  `launch.fl_round.make_fl_round_step` on full-width
             hymba-1.5b (bf16) as one pod of the NCCL group: 2 local
             proximal SGD steps on a (2, 2048) batch, seconds a round,
             peak memory, a launch of each LM kernel a layer a step, two
             all-reduces; weight 0 and steps 0 give the params back bit
             for bit; a participating round's delta (out - params)
             within one bfloat16 rounding an element, and 0.125 in L2,
             of an oracle's: two plain SGD steps in bf16 and
             `weighted_delta_update` on the card; the same check must
             reject the round at half the lr and with its sign flipped;
  ep_moe     one grok-1 MoE block at full width (d 6144, 8 experts of
             32,768, top-2, capacity factor 1.5, bf16, x (4, 2048, 6144))
             through `apply_moe_ep` on the NCCL group against `apply_moe`
             on the (1, 8192, 6144) view: output, aux and gradients
             within 2e-2; forward and backward ms of both; all-to-all
             bytes;
  lm_cpu_vs_card  lm_tiny and lm_moe_tiny fedprox on the card and on the
             CPU from the same init and draws: RoundRecords identical,
             params within 1e-4; one training step of reduced hymba-1.5b,
             gemma-2b, rwkv6-1.6b, grok-1, whisper-medium, llava (seeded
             random frames and prefix embeddings) and deepseek-v3 from the
             same weights: loss and every gradient within 1e-4 (of the
             leaf's largest where that passes 1).
  dryrun     `repro_torch.launch.dryrun` (no GPU: DTensors on `meta`
             over a fake process group) for hymba-1.5b train_4k on the
             16 x 16 mesh (probe-checked) and prefill_32k on the 2 x 16
             x 16 mesh, each in a process of its own: status ok; and the
             dry run's one-device count of lm_train's step and serve's
             prefill: the roofline terms (H100 data-sheet constants) and
             measured / bound beside the times measured above, each
             measured time at least its compute term, the training
             step's useful_flops_ratio in [0.5, 1.0]; and deepseek-v3
             train_4k and prefill_32k on 16 x 16 with and without
             `--ep` (uncalibrated): status ok, the expert-parallel runs'
             all-to-all bytes exactly E * C * d * 2 a token exchange
             times the exchanges a routed layer issues times its 58
             routed layers, and their collective term below the
             row-local runs'; one roofline line each.

Each phase prints one JSON line; any failure exits non-zero before the
last line, which is {"ok": true, "device": {...}}. The process group is
destroyed before the last lines.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import inspect
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.comms import (  # noqa: E402
    ConstantRate,
    LinkBudget,
    build_contact_plan,
    compute_isl_windows,
)
from repro_torch.comms import isl  # noqa: E402
from repro_torch.comms.routing import batch_earliest_arrival  # noqa: E402
from repro_torch.configs import get_config, lm_arch_ids  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ALGORITHMS,
    TABLE1_NAMES,
    FedProxSat,
    spaceify,
)
from repro_torch.core.aggregation import weighted_delta_update  # noqa: E402
from repro_torch.core.timing import HardwareModel  # noqa: E402
from repro_torch.data import synth_femnist  # noqa: E402
from repro_torch.data.tokens import synthetic_token_batch  # noqa: E402
from repro_torch.kernels import build, ops, ref, ssd  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    model_flops,
    roofline_terms,
)
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch import mesh as mesh_consts  # noqa: E402
from repro_torch.launch.fl_round import make_fl_round_step  # noqa: E402
from repro_torch.models.lm.rwkv import recomputed_layers  # noqa: E402
from repro_torch.core.client import vmapped_client_update  # noqa: E402
from repro_torch.core.workload import get_workload, lm_workload  # noqa: E402
from repro_torch.models.femnist_cnn import femnist_cnn_init  # noqa: E402
from repro_torch.models.femnist_mlp import femnist_mlp_init  # noqa: E402
from repro_torch.models.lm.config import Segment  # noqa: E402
from repro_torch.models.lm.moe import (  # noqa: E402
    apply_moe,
    apply_moe_ep,
    init_moe,
)
from repro_torch.models.lm.params import (  # noqa: E402
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.models.lm.transformer import (  # noqa: E402
    count_params,
    init_decode_cache,
    init_params,
)
from repro_torch.optim.adam import adam_init  # noqa: E402
from repro_torch.orbits import (  # noqa: E402
    WalkerStar,
    compute_access_windows,
    station_subnetwork,
)
from repro_torch.params import FEMNIST_CNN, params_to_numpy  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    BatchedSweep,
    ConstellationSim,
    SimConfig,
    TorchSampler,
)
from repro_torch.sim.batched import _fast_plannable  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    COLLECTIVES,
    default_group,
    reset_collectives,
)
from repro_torch.sharding.compat import backend_for  # noqa: E402
from repro_torch.sim.engine import client_steps  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    lm_loss,
    make_serve_step,
    make_train_step,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# H100 SXM data sheet (`repro_torch.launch.mesh`, the dry run's roofline
# constants): HBM3 bandwidth, float32 rate outside the tensor cores, and
# the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = mesh_consts.HBM_BW
F32_FLOPS_PER_S = mesh_consts.F32_FLOPS_PER_S
BF16_FLOPS_PER_S = mesh_consts.PEAK_FLOPS_BF16
TIMED_LAUNCHES = 100
SLEEP_CYCLES = 100_000_000           # ~50 ms of device sleep at ~2 GHz
COLD_LAUNCHES = 50
FLUSH_BYTES = 256 << 20              # written before each cold launch: > L2
HOST_CALLS = 1000
P_MLP = 46_639                       # femnist_mlp parameters
P_CNN = 47_887                       # femnist_cnn parameters
BATCH_S, BATCH_C = 32, 10            # the batched sweep's kernel shapes


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ card
BF16_BWD_KERNELS = ("flash_bwd_dq_tc", "flash_bwd_dkdv_tc")


def phase_card() -> dict:
    line = smi_line()
    print(line, flush=True)
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, timeout=60,
                                  check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    # ptxas's registers and spills, and from the machine code the count of
    # tensor-core (HGMMA/HMMA) and asynchronous-copy (UTMALDG/LDGSTS)
    # instructions, per kernel.
    sass = {r["kernel"]: r for r in build.sass_counts()}
    resources = [dict(row, **{k: v for k, v in sass.get(row["kernel"],
                                                        {}).items()
                              if k != "kernel"})
                 for row in build.resource_usage()]
    info = dict(nvidia_smi=line, name=torch.cuda.get_device_name(0),
                torch=torch.__version__, cuda=torch.version.cuda,
                nvcc=nvcc_version, python=sys.version.split()[0],
                kernel_build_s=build_s, kernel_resources=resources)
    emit("card", **info)
    bf16_flash = [r for r in resources
                  if "flash_bf16_kernel" in r["kernel"]]
    require(bool(bf16_flash) and all(r.get("tensor_core_ops", 0) > 0
                                     for r in bf16_flash),
            "a bf16 flash_attention kernel has no tensor-core instruction: "
            f"{bf16_flash}")
    # The bf16 backward's dq and dk/dv kernels at (D, Dv) = (64, 64),
    # (128, 128), (256, 256) and (192, 128).
    bf16_bwd = [r for r in resources
                if any(n in r["kernel"] for n in BF16_BWD_KERNELS)]
    require(len(bf16_bwd) == 4 * len(BF16_BWD_KERNELS)
            and all(r.get("tensor_core_ops", 0) > 0 for r in bf16_bwd),
            "a bf16 flash_attention_bwd kernel is missing or has no "
            f"tensor-core instruction: {bf16_bwd}")
    return info


# --------------------------------------------------------------- kernels
def device_ms(fn) -> float:
    """Median device time of one call of `fn`, from CUDA events around
    each of TIMED_LAUNCHES calls enqueued while the device sleeps."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_LAUNCHES + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    events[0].record()
    for i in range(TIMED_LAUNCHES):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(TIMED_LAUNCHES))


def device_ms_back_to_back(fn) -> float:
    """Mean device time of one call of `fn` over TIMED_LAUNCHES calls run
    back to back between one pair of CUDA events (queued behind a device
    sleep), as the main path launches them: no event between calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(TIMED_LAUNCHES):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_LAUNCHES


def device_ms_cold(fn, flush: torch.Tensor) -> float:
    """Median device time of one call of `fn` with the L2 evicted first:
    `flush` (FLUSH_BYTES) is written and then read before each of
    COLD_LAUNCHES calls (read, so that the lines the call evicts are
    clean and their write-back is not counted against it), and one pair
    of CUDA events around each call leaves the flush untimed. The calls
    queue behind a device sleep, as in `device_ms`."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(COLD_LAUNCHES)]
    total = torch.empty((), device=flush.device)
    torch.cuda._sleep(SLEEP_CYCLES)
    for i, (start, end) in enumerate(pairs):
        flush.fill_(float(i))
        torch.sum(flush, dim=0, out=total)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn) -> float:
    """Median host microseconds of one call of `fn` over HOST_CALLS calls,
    started on an idle device (each call only enqueues its launch)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def _max_err(got, want, rtol: float, atol: float | None = None) -> float:
    """Max |got - want|; fails unless every element is within
    atol + rtol * |want| (atol = rtol unless given)."""
    atol = rtol if atol is None else atol
    got, want = got.float(), want.float()
    if got.numel() == 0:
        return 0.0
    require(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    require(ok, f"kernel disagrees with its plain version: max abs err "
                f"{float(err.max())} > atol {atol} + rtol {rtol} * |want|")
    return float(err.max())


FEDAGG_FORMS = ("plain", "delta", "partial")


def check_fedagg(dev, K: int, P: int, dtype: str, form: str,
                 flush: torch.Tensor | None) -> dict:
    """The kernel in `form` (FEDAGG_FORMS: the weighted sum, its delta
    form against a base, or the partial form a mesh rank contributes)
    against its plain version, then timed; with no `flush` buffer only
    the comparison is made."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(K * P)
    x = torch.randn((K, P), generator=g, device=dev).to(dt)
    w = torch.rand((K,), generator=g, device=dev)
    base = torch.randn((P,), generator=g, device=dev).to(dt) \
        if form != "plain" else None
    scale = 0.5 if form == "delta" else 1.0
    partial = form == "partial"
    got = ops.fedagg_op(x, w, base, scale, partial)
    want = ref.fedagg_ref(x, w, base, scale, partial)
    torch.cuda.synchronize()
    err = _max_err(got, want, TOL[dtype])
    row = dict(name="fedagg", form=form, K=K, P=P, dtype=dtype,
               max_abs_err=err, tol=TOL[dtype])
    if flush is None:
        return row
    es = x.element_size()
    n_bytes = K * P * es + K * 4 + P * es + (P * es if base is not None
                                             else 0)
    n_flops = {"plain": 2 * K * P, "delta": 3 * K * P + 2 * P,
               "partial": 3 * K * P}[form]
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    wl = w.to(dt)
    # One PyTorch call computing the same function (a yardstick only):
    # sum_k w_k x_k - beta * base is one addmv, with beta precomputed.
    sw = float(w.sum())
    library = {
        "plain": lambda: torch.mv(x.t(), wl),
        "delta": lambda: torch.addmv(base, x.t(), wl, beta=1 - scale * sw,
                                     alpha=scale),
        "partial": lambda: torch.addmv(base, x.t(), wl, beta=-sw)}[form]
    kernel = lambda: ops.fedagg_op(x, w, base, scale, partial)  # noqa: E731
    return dict(
        row, ms=device_ms(kernel), ms_cold=device_ms_cold(kernel, flush),
        ms_back_to_back=device_ms_back_to_back(kernel),
        host_us=host_us(kernel),
        plain_ms=device_ms(lambda: ref.fedagg_ref(x, w, base, scale,
                                                  partial)),
        library_ms=device_ms(library), bound_ms=b_ms, bound_by=b_by)


def check_prox_sgd(dev, C: int, P: int, dtype: str, mu: float,
                   shared_anchor: bool, flush: torch.Tensor | None,
                   all_live: bool = False) -> dict:
    """Partly masked (3 of every 10 clients past their step budget), or
    with `all_live` every client live. Checked against the plain version,
    then timed; with no `flush` buffer only the comparison is made."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(C + P)
    w = torch.randn((C, P), generator=g, device=dev).to(dt)
    grad = torch.randn((C, P), generator=g, device=dev).to(dt)
    anchor = torch.randn((P,) if shared_anchor else (C, P), generator=g,
                         device=dev).to(dt)
    steps = torch.tensor([2 if c % 10 >= 7 and not all_live else 8
                          for c in range(C)], dtype=torch.int32, device=dev)
    step, lr = 3, 0.05
    got, want = w.clone(), w.clone()
    ops.prox_sgd_op(got, grad, anchor, steps, step, lr, mu)
    ref.prox_sgd_masked_ref_(want, grad, anchor, steps, step, lr, mu)
    torch.cuda.synchronize()
    err = _max_err(got, want, TOL[dtype])
    masked = steps <= step
    require(bool(torch.equal(got[masked], w[masked])),
            "prox_sgd wrote a masked row")
    live = int((~masked).sum())
    if flush is None:
        return dict(name="prox_sgd", C=C, P=P, dtype=dtype, mu=mu,
                    anchor="shared" if shared_anchor else "per_client",
                    live=live, max_abs_err=err, tol=TOL[dtype])
    es = w.element_size()
    n_bytes = 3 * live * P * es + (P if shared_anchor else live * P) * es \
        + C * 4
    b_ms, b_by = bound_ms(n_bytes, 5 * live * P)
    wk, wp, wl = w.clone(), w.clone(), w.clone()
    kernel = lambda: ops.prox_sgd_op(  # noqa: E731
        wk, grad, anchor, steps, step, lr, mu)
    return dict(
        name="prox_sgd", C=C, P=P, dtype=dtype, mu=mu,
        anchor="shared" if shared_anchor else "per_client", live=live,
        max_abs_err=err, tol=TOL[dtype],
        ms=device_ms(kernel), ms_cold=device_ms_cold(kernel, flush),
        ms_back_to_back=device_ms_back_to_back(kernel),
        host_us=host_us(kernel),
        plain_ms=device_ms(lambda: ref.prox_sgd_masked_ref_(
            wp, grad, anchor, steps, step, lr, mu)),
        # With every client live and mu = 0 the step is w - lr * g: one
        # PyTorch call computes it there (a yardstick only).
        library_ms=(device_ms(lambda: wl.add_(grad, alpha=-lr))
                    if live == C and mu == 0.0 else None),
        bound_ms=b_ms, bound_by=b_by)


def check_prox_sgd_rows(dev, R: int, P: int, group: int,
                        flush: torch.Tensor | None,
                        mu: tuple | None = None, **label) -> dict:
    """The extended form on R rows, 7 of every 10 live, anchors one row
    per `group` rows ((R / group, P); group 1 is per client) and per-row
    mu (given, or 0.01 on every third row and 0 elsewhere). Checked
    against the plain version, bitwise in f32, then timed; with no `flush`
    buffer only the comparison is made."""
    g = torch.Generator(device=dev).manual_seed(R + P + group)
    w = torch.randn((R, P), generator=g, device=dev)
    grad = torch.randn((R, P), generator=g, device=dev)
    anchor = torch.randn((R // group, P), generator=g, device=dev)
    steps = torch.tensor([2 if r % 10 >= 7 else 8 for r in range(R)],
                         dtype=torch.int32, device=dev)
    mu_t = torch.tensor(mu if mu is not None else
                        [0.01 if r % 3 == 0 else 0.0 for r in range(R)],
                        dtype=torch.float32, device=dev)
    step, lr = 3, 0.05
    got, want = w.clone(), w.clone()
    ops.prox_sgd_op(got, grad, anchor, steps, step, lr, mu_t)
    ref.prox_sgd_rows_ref_(want, grad, anchor, steps, step, lr, mu_t)
    torch.cuda.synchronize()
    err = _max_err(got, want, TOL["float32"])
    require(bool(torch.equal(got, want)),
            "prox_sgd (rows form) is not bitwise its plain version in f32")
    masked = steps <= step
    require(bool(torch.equal(got[masked], w[masked])),
            "prox_sgd wrote a masked row")
    live = int((~masked).sum())
    row = dict(name="prox_sgd", form="rows", **label, R=R, P=P,
               dtype="float32", mu="rows", anchor_group=group, live=live,
               max_abs_err=err, tol=TOL["float32"])
    if flush is None:
        return row
    # Live rows read w and g and write w; each anchor row a live row uses
    # is read once; every row's step budget and mu.
    used = len({r // group for r in range(R) if not masked[r]})
    n_bytes = (3 * live + used) * P * 4 + R * 8
    b_ms, b_by = bound_ms(n_bytes, 5 * live * P)
    wk, wp = w.clone(), w.clone()
    kernel = lambda: ops.prox_sgd_op(  # noqa: E731
        wk, grad, anchor, steps, step, lr, mu_t)
    return dict(
        row, ms=device_ms(kernel), ms_cold=device_ms_cold(kernel, flush),
        ms_back_to_back=device_ms_back_to_back(kernel),
        host_us=host_us(kernel),
        plain_ms=device_ms(lambda: ref.prox_sgd_rows_ref_(
            wp, grad, anchor, steps, step, lr, mu_t)),
        # No one PyTorch call computes a per-row-mu proximal step.
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_fedagg_batched(dev, S: int, K: int, P: int, delta: bool,
                         flush: torch.Tensor | None) -> dict:
    """The batched form (S scenarios of K clients) against its plain
    version (same tolerance as the unbatched rows), one scenario's
    weights all zero (its delta form must return its base bit for bit),
    then timed; with no `flush` buffer only the comparison is made."""
    g = torch.Generator(device=dev).manual_seed(S * K + P)
    x = torch.randn((S, K, P), generator=g, device=dev)
    w = torch.rand((S, K), generator=g, device=dev)
    w[S // 2] = 0.0
    base = torch.randn((S, P), generator=g, device=dev) if delta else None
    scale = torch.rand((S,), generator=g, device=dev) + 0.5
    got = ops.fedagg_op(x, w, base, scale)
    want = ref.fedagg_batched_ref(x, w, base, scale)
    torch.cuda.synchronize()
    err = _max_err(got, want, TOL["float32"])
    if delta:
        require(bool(torch.equal(got[S // 2], base[S // 2])),
                "fedagg: an all-zero scenario did not keep its base")
    row = dict(name="fedagg", form="batched_delta" if delta
               else "batched_plain", S=S, K=K, P=P, dtype="float32",
               max_abs_err=err, tol=TOL["float32"])
    if flush is None:
        return row
    n_bytes = S * K * P * 4 + S * K * 4 + S * P * 4 + (
        S * P * 4 + S * 4 if delta else 0)
    n_flops = S * (3 * K * P + 2 * P) if delta else 2 * S * K * P
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    kernel = lambda: ops.fedagg_op(x, w, base, scale)  # noqa: E731
    return dict(
        row, ms=device_ms(kernel), ms_cold=device_ms_cold(kernel, flush),
        ms_back_to_back=device_ms_back_to_back(kernel),
        host_us=host_us(kernel),
        plain_ms=device_ms(lambda: ref.fedagg_batched_ref(x, w, base,
                                                          scale)),
        # One PyTorch call computes the plain form: a batched
        # vector-matrix product (a yardstick only).
        library_ms=(None if delta else
                    device_ms(lambda: torch.bmm(w[:, None], x))),
        bound_ms=b_ms, bound_by=b_by)


def phase_kernels(dev) -> list[dict]:
    """The simulator's kernels' rows; the phase's line also carries the
    floor of an empty launch (`torch.cuda._sleep(0)`) timed as the kernels
    are (`floor_ms`, and back to back: `floor_back_to_back_ms`)."""
    flush = torch.empty((FLUSH_BYTES // 4,), device=dev)
    rows = []
    for dtype in ("float32", "bfloat16"):
        for K, P in ((10, P_MLP), (100, P_MLP), (7, 12345)):
            for form in FEDAGG_FORMS:
                rows.append(check_fedagg(dev, K, P, dtype, form, flush))
        for C in (10, 100):
            for mu in (0.0, 0.1):
                for shared in (True, False):
                    rows.append(check_prox_sgd(dev, C, P_MLP, dtype,
                                               mu, shared, flush))
            rows.append(check_prox_sgd(dev, C, P_MLP, dtype, 0.0, True,
                                       flush, all_live=True))
    # The batched sweep's shapes: 32 scenarios of 10 clients, femnist_cnn.
    for group in (BATCH_C, 1):
        rows.append(check_prox_sgd_rows(dev, BATCH_S * BATCH_C, P_CNN, group,
                                        flush, S=BATCH_S, C=BATCH_C))
    for delta in (False, True):
        rows.append(check_fedagg_batched(dev, BATCH_S, BATCH_C, P_CNN, delta,
                                         flush))
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor = device_ms(empty)
    del flush
    emit("kernels", floor_ms=floor,
         floor_back_to_back_ms=device_ms_back_to_back(empty), rows=rows)
    return rows


# The LM kernels' launchers in `ops`, each with its tensor arguments.
LM_KERNELS = ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd")
# The SSD heads' launchers in `kernels.ssd`, which `ops.ssd_heads_op`
# calls (`ssd_front_bwd` also launches `ssd_reduce`).
SSD_LAUNCHERS = ("ssd_front", "ssd_back", "ssd_back_bwd", "ssd_front_bwd")


def _layout(t) -> tuple | None:
    """A tensor argument as a launch saw it: shape, strides, storage
    offset and dtype (None for an absent optional tensor)."""
    if t is None:
        return None
    return (tuple(t.shape), tuple(t.stride()), t.storage_offset(),
            str(t.dtype).removeprefix("torch."))


class LaunchShapes:
    """Records the distinct shapes of the kernels' launches while it is
    entered, by wrapping the launchers that `ops`' counted wrappers call
    (the launch counts are untouched), so that `phase_path_shapes` can
    hold the kernels to their plain versions at exactly the shapes a path
    gave them: for `fedagg` the scenario axis (0 for none), K, P, dtype
    and form; for `prox_sgd` C, P, dtype, mu (a float, or the values of a
    per-row vector) and the anchor (shared, per client, or one row per
    group of rows); for the LM kernels every tensor argument's
    `_layout` (so a cross-attention's keys keep their own length) and
    the keyword options; for the SSD launchers each argument by name,
    tensors as their `_layout` (the client axis, the weights' client
    strides and the conv tail included), the lengths as given.
    `kernels` names the kernels the path must launch."""

    def __init__(self, *kernels: str):
        self.kernels = kernels
        self.fedagg: set[tuple] = set()
        self.prox_sgd: set[tuple] = set()
        self.lm: dict[str, set[tuple]] = {
            name: set() for name in LM_KERNELS + SSD_LAUNCHERS}
        self._mu_rows: dict[tuple, tuple] = {}

    def launched(self, name: str) -> bool:
        name = "ssd_front_bwd" if name == "ssd_reduce" else name
        return bool(self.lm[name] if name in self.lm
                    else getattr(self, name))

    def _mu_key(self, mu) -> float | tuple:
        if not isinstance(mu, torch.Tensor):
            return float(mu)
        key = (mu.data_ptr(), mu.numel())   # read once per vector
        if key not in self._mu_rows:
            self._mu_rows[key] = tuple(mu.tolist())
        return self._mu_rows[key]

    def _record_lm(self, name: str, launcher):
        def record(*args, **kw):
            self.lm[name].add((tuple(_layout(a) for a in args),
                               tuple(sorted(kw.items()))))
            return launcher(*args, **kw)
        return record

    def _record_ssd(self, name: str, launcher):
        params = inspect.signature(launcher).parameters

        def record(*args, **kw):
            named = dict(zip(params, args), **kw)
            self.lm[name].add(tuple(
                (k, _layout(v) if v is None or isinstance(v, torch.Tensor)
                 else v) for k, v in named.items()))
            return launcher(*args, **kw)
        return record

    def __enter__(self) -> "LaunchShapes":
        self._launchers = fedagg, prox_sgd = ops.fedagg, ops.prox_sgd
        self._lm_launchers = {name: getattr(ops, name) for name in LM_KERNELS}
        for name, launcher in self._lm_launchers.items():
            setattr(ops, name, self._record_lm(name, launcher))
        self._ssd_launchers = {name: getattr(ssd, name)
                               for name in SSD_LAUNCHERS}
        for name, launcher in self._ssd_launchers.items():
            setattr(ssd, name, self._record_ssd(name, launcher))

        def record_fedagg(x, w, base, scale, partial=False):
            self.fedagg.add((x.shape[0] if x.dim() == 3 else 0,
                             x.shape[-2], x.shape[-1],
                             str(x.dtype).removeprefix("torch."),
                             "partial" if partial else
                             "plain" if base is None else "delta"))
            return fedagg(x, w, base, scale, partial)

        def record_prox_sgd(w, g, w0, steps, step, lr, mu):
            rows = w0.shape[0] if w0.dim() == 2 else 1
            anchor = ("shared" if rows == 1 else "per_client"
                      if rows == w.shape[0] else w.shape[0] // rows)
            self.prox_sgd.add((w.shape[0], w.shape[1],
                               str(w.dtype).removeprefix("torch."),
                               self._mu_key(mu), anchor))
            return prox_sgd(w, g, w0, steps, step, lr, mu)

        ops.fedagg, ops.prox_sgd = record_fedagg, record_prox_sgd
        return self

    def __exit__(self, *exc) -> None:
        ops.fedagg, ops.prox_sgd = self._launchers
        for name, launcher in self._lm_launchers.items():
            setattr(ops, name, launcher)
        for name, launcher in self._ssd_launchers.items():
            setattr(ssd, name, launcher)


def _prox_label(r: dict) -> str:
    if r.get("form") == "rows":
        return (f"R={r['R']} P={r['P']} {r['dtype']} mu=rows "
                f"group={r['anchor_group']}")
    return f"C={r['C']} P={r['P']} {r['dtype']} mu={r['mu']} {r['anchor']}"


def _strided(layout: tuple, g: torch.Generator, dev,
             decay: bool = False, scale: float = 1.0,
             shift: float = 0.0) -> torch.Tensor:
    """Random normal values (with `decay`, -0.3 |normal|: a log decay;
    else shift + scale normal) laid out as `layout` (`_layout`): the same
    shape, strides (transposed and broadcast views too) and offset."""
    shape, stride, offset, dtype = layout
    n = offset + 1 + sum((m - 1) * st for m, st in zip(shape, stride))
    buf = torch.randn(n, generator=g, device=dev)
    if decay:
        buf = -0.3 * buf.abs()
    elif scale != 1.0 or shift:
        buf = shift + scale * buf
    return buf.to(getattr(torch, dtype)).as_strided(shape, stride, offset)


def _dense_strides(shape: tuple) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def check_lm_shape(dev, name: str, layouts: tuple, options: tuple) -> dict:
    """One LM kernel against its plain version on random inputs laid out
    exactly as a recorded launch's (`LaunchShapes`), at the tolerances of
    `lm_kernels` and `lm_train_kernels`; no timing."""
    g = torch.Generator(device=dev).manual_seed(math.prod(layouts[0][0]))
    kw = dict(options)
    # wkv6's fourth argument is logw, a log decay (<= 0); the backward
    # kernels' saved forward statistics (flash's lse, wkv6_bwd's chunk
    # states) are made by the plain forward below, not drawn.
    saved = {"flash_attention_bwd": 5, "wkv6_bwd": 7}.get(name)
    t = [None if lay is None or i == saved else _strided(
             lay, g, dev, decay=name.startswith("wkv6") and i == 3)
         for i, lay in enumerate(layouts)]
    dtype = layouts[0][3]
    if name == "flash_attention":
        got = flash_attention(*t, **kw)
        want = ref.flash_attention_ref(*t, **kw)
        if kw.get("return_lse"):            # (o, lse): lse in f32
            errs = [_max_err(got[0], want[0], *FLASH_TOL[dtype]),
                    _max_err(got[1], want[1], *FLASH_TOL["float32"])]
        else:
            errs = [_max_err(got, want, *FLASH_TOL[dtype])]
    elif name == "flash_attention_bwd":
        o, t[5] = ref.flash_attention_ref(*t[:3], return_lse=True, **kw)
        t[3].copy_(o)
        got = flash_attention_bwd(*t, **kw)
        want = ref.flash_attention_bwd_ref(*t[:5], lse=t[5], **kw)
        errs = [_max_err(a, w, *BWD_TOL[dtype]) for a, w in zip(got, want)]
    elif name == "wkv6":
        got = wkv6(*t, **kw)
        want = ref.wkv6_ref(*t, **kw)
        errs = [_max_err(a, w, WKV6_TOL) for a, w in zip(got, want)]
    else:
        t[7] = ref.wkv6_ref(*t[:5], chunk=kw["chunk"], return_states=True)[2]
        got = wkv6_bwd(*t, **kw)
        want = ref.wkv6_bwd_ref(*t[:7], kw["chunk"], t[7])
        errs, _ = _wkv6_bwd_errs(t[0], t[1], got, want)
    torch.cuda.synchronize()
    return dict(name=name, label=_lm_label(name, layouts, options),
                max_abs_err=max(errs))


def _lm_label(name: str, layouts: tuple, options: tuple = ()) -> str:
    given = [lay for lay in layouts if lay is not None]
    shapes = ", ".join(dict.fromkeys("x".join(map(str, lay[0]))
                                     for lay in given))
    dense = all(lay[1] == _dense_strides(lay[0]) for lay in given)
    opts = " ".join(f"{k}={v}" for k, v in options)
    return (f"{name} {shapes} {given[0][3]} {opts}"
            + ("" if dense else " views"))


def phase_path_shapes(dev, shapes: dict[str, LaunchShapes]) -> dict:
    """Every kernel against its plain version at every distinct shape
    each path launched it with (partial-visit and buffered flushes,
    sparse rounds, the batched sweep's scenario axis, per-row mu and
    grouped anchors; the LM kernels at the shapes, strides and options
    the model passed; the SSD kernels, forward and backward, at every
    client stack, length, weight layout and conv tail the model passed),
    on fresh random inputs: no timing, the `kernels`, `lm_kernels` and
    `lm_train_kernels` phases time their shapes."""
    out = {}
    for path, rec in shapes.items():
        missing = [k for k in rec.kernels if not rec.launched(k)]
        require(not missing, f"{path}: no launch of {missing} was recorded")
        rows = [check_fedagg_batched(dev, S, K, P, form == "delta", None)
                if S else check_fedagg(dev, K, P, dtype, form, None)
                for S, K, P, dtype, form in sorted(rec.fedagg)]
        for C, P, dtype, mu, anchor in sorted(rec.prox_sgd, key=str):
            if isinstance(mu, float) and anchor in ("shared", "per_client"):
                rows.append(check_prox_sgd(dev, C, P, dtype, mu,
                                           anchor == "shared", None))
            else:
                group = {"shared": C, "per_client": 1}.get(anchor, anchor)
                rows.append(check_prox_sgd_rows(
                    dev, C, P, group, None,
                    mu=mu if isinstance(mu, tuple) else (mu,) * C))
        rows += [check_lm_shape(dev, name, layouts, options)
                 for name in LM_KERNELS
                 for layouts, options in sorted(rec.lm[name], key=str)]
        ssd_rows = [row for key, chain in sorted(_ssd_chains(rec).items(),
                                                 key=str)
                    for row in check_ssd_shape(dev, key, chain)]
        out[path] = dict(
            fedagg=[f"{r['form']} " + (f"S={r['S']} " if "S" in r else "")
                    + f"K={r['K']} P={r['P']} {r['dtype']}"
                    for r in rows if r["name"] == "fedagg"],
            prox_sgd=[_prox_label(r) for r in rows
                      if r["name"] == "prox_sgd"],
            lm=[r["label"] for r in rows if "label" in r],
            ssd=[r["label"] for r in ssd_rows],
            max_abs_err=max((r["max_abs_err"] for r in rows), default=None),
            ssd_max_rel_err=max((r["max_rel_err"] for r in ssd_rows),
                                default=None))
    emit("path_shapes", **out)
    return out


def _check_final_params(label: str, res, n_params: int = P_MLP) -> None:
    require(res.final_params is not None, f"{label}: no final params")
    leaves = [v for layer in res.final_params.values()
              for v in layer.values()]
    require(sum(v.size for v in leaves) == n_params
            and all(bool(np.isfinite(v).all()) for v in leaves),
            f"{label}: bad final params")


def _flat_params(final_params: dict) -> np.ndarray:
    """A run's final params (nested numpy dict) as one vector, in layout
    order."""
    return np.concatenate([v.reshape(-1) for layer in final_params.values()
                           for v in layer.values()])


RECORD_FIELDS = ("idx", "t_start", "t_end", "participants", "epochs",
                 "idle_s", "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes", "wire_bytes_saved")


def _records(res) -> list:
    return [[getattr(r, f) for f in RECORD_FIELDS] for r in res.rounds]


# ------------------------------------------------------------- main path
MAIN_CELL = "c10s10/g13"
MAIN_HORIZON_S = 2 * 86400.0


def main_path_setup(dev) -> dict:
    """The paper's largest cell (100 satellites, 13 stations): data,
    constellation, stations and access windows (computed on the card)."""
    t0 = time.perf_counter()
    data = synth_femnist(100, seed=0)
    data_s = time.perf_counter() - t0
    cst, st = WalkerStar(10, 10), station_subnetwork(13)
    t0 = time.perf_counter()
    aw = compute_access_windows(cst, st, horizon_s=MAIN_HORIZON_S,
                                device=dev)
    torch.cuda.synchronize()
    return dict(data=data, cst=cst, st=st, aw=aw, data_s=data_s,
                access_windows_s=time.perf_counter() - t0)


def phase_main_path(dev, setup: dict) -> dict:
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=20, horizon_s=MAIN_HORIZON_S, eval_every=5)
    per_alg = []
    ops.reset_launches()          # the main path's counts start here
    for name in TABLE1_NAMES:
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        sim = ConstellationSim(cst, st, ALGORITHMS[name],
                               data=data, cfg=cfg, access=aw, device=dev)
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        accs = [a for _, _, a in res.accuracy_curve]
        per_alg.append(dict(algorithm=name, rounds=res.n_rounds,
                            wall_s=wall, accuracy=accs,
                            launches=launches))
        setup.setdefault("main_runs", {})[name] = res   # for mesh_path
        require(res.n_rounds >= 10,
                f"{name}: {res.n_rounds} rounds (< 10) in 2 days")
        require(launches["prox_sgd"] > 0 and launches["fedagg"] > 0,
                f"{name}: a kernel was never launched: {launches}")
        require(sim.device.type == "cuda",
                f"{name}: final params did not come from the card")
        _check_final_params(name, res)
        require(bool(accs) and all(math.isfinite(a) for a in accs),
                f"{name}: accuracy not finite: {accs}")
    totals = dict(ops.LAUNCHES)
    out = dict(cell=MAIN_CELL, horizon_days=MAIN_HORIZON_S / 86400.0,
               data_s=setup["data_s"],
               access_windows_s=setup["access_windows_s"],
               algorithms=per_alg, launches=totals)
    emit("main_path", **out)
    return out


# ------------------------------------------------------------- mesh path
# The algorithms whose every round's params the mesh path holds to the
# host path's (`SimConfig(record_params=True)`).
MESH_RECORDED = ("fedavg", "fedprox", "fedbuff")


def _nccl_group(dev):
    """The one-rank default group (`sharding.default_group`), whose CUDA
    tensors must reduce through NCCL."""
    group = default_group(dev)
    backend = backend_for(torch.zeros(1, device=dev), group)
    require(backend == "nccl", f"CUDA collectives run on {backend}")
    return group


def phase_mesh_path(dev, setup: dict) -> dict:
    """The main path again with execution="mesh" (all 8 Table-1
    algorithms, the same cell, 20 rounds), on a one-rank group whose CUDA
    backend is NCCL, launch and collective counters zeroed just before
    and read just after: RoundRecords identical to main_path's, final
    params within 1e-5 of its; prox_sgd launches equal to main_path's,
    one fedagg launch and two all-reduces a round or flush.
    For fedavg, fedprox and fedbuff every round's params against a host
    run's, within 1e-5. Walls beside main_path's."""
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    group = _nccl_group(dev)
    main_runs = setup["main_runs"]
    per_alg = []
    ops.reset_launches()          # the mesh path's counts start here
    reset_collectives()
    for name in TABLE1_NAMES:
        cfg = SimConfig(max_rounds=20, horizon_s=MAIN_HORIZON_S,
                        eval_every=5, record_params=name in MESH_RECORDED)
        before, coll = dict(ops.LAUNCHES), dict(COLLECTIVES)
        t0 = time.perf_counter()
        res = ConstellationSim(cst, st, ALGORITHMS[name], data=data,
                               cfg=cfg, access=aw, device=dev,
                               execution="mesh").run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        colls = {k: COLLECTIVES[k] - coll[k] for k in COLLECTIVES}
        host = main_runs[name]
        require(res.execution == "mesh"
                and all(r.execution == "mesh" for r in res.rounds),
                f"{name}: not a mesh run")
        require(_records(res) == _records(host),
                f"{name}: mesh RoundRecords differ from main_path's")
        gap = float(np.abs(_flat_params(res.final_params)
                           - _flat_params(host.final_params)).max())
        require(gap <= 1e-5, f"{name}: mesh final params {gap} from "
                             "main_path's")
        host_launches = next(a["launches"] for a in
                             setup["main_path"]["algorithms"]
                             if a["algorithm"] == name)
        require(launches["prox_sgd"] == host_launches["prox_sgd"]
                and launches["fedagg"] == res.n_rounds
                and colls["all_reduce"] == 2 * res.n_rounds,
                f"{name}: mesh launches {launches}, collectives {colls}, "
                f"{res.n_rounds} rounds; main_path {host_launches}")
        row = dict(algorithm=name, rounds=res.n_rounds, wall_s=wall,
                   main_path_wall_s=next(
                       a["wall_s"] for a in setup["main_path"]["algorithms"]
                       if a["algorithm"] == name),
                   final_params_max_abs_gap=gap, launches=launches,
                   collectives=colls)
        if name in MESH_RECORDED:
            ref_run = ConstellationSim(cst, st, ALGORITHMS[name], data=data,
                                       cfg=cfg, access=aw, device=dev).run()
            gaps = [float(np.abs(_flat_params(a) - _flat_params(b)).max())
                    for a, b in zip(res.params_history,
                                    ref_run.params_history)]
            require(len(gaps) == res.n_rounds and max(gaps) <= 1e-5,
                    f"{name}: per-round params gaps {gaps}")
            row["round_params_max_abs_gap"] = max(gaps)
        per_alg.append(row)
    # The mesh runs' counts (not the host runs' beside three of them).
    out = dict(cell=MAIN_CELL, backend="nccl",
               world_size=dist.get_world_size(group), algorithms=per_alg,
               launches={k: sum(a["launches"][k] for a in per_alg)
                         for k in ops.LAUNCHES},
               collectives={k: sum(a["collectives"][k] for a in per_alg)
                            for k in COLLECTIVES})
    emit("mesh_path", **out)
    return out


# ------------------------------------------------------ where time goes
PROFILE_ALGORITHM = "fedprox"
PROFILE_ROUNDS = 5


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_where_time_goes(dev, setup: dict) -> dict:
    """One Table-1 algorithm for a few rounds on the main-path cell, run
    three times: plain (host wall clock), traced with `repro_torch.obs`
    (per-span walls; each traced span ends in a device sync) and under
    `torch.profiler` (device busy time and kernel time by name). The
    device's idle share is 1 - busy / the plain run's wall time."""
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=PROFILE_ROUNDS, horizon_s=MAIN_HORIZON_S,
                    eval_every=5)

    def run() -> float:
        t0 = time.perf_counter()
        ConstellationSim(cst, st, ALGORITHMS[PROFILE_ALGORITHM], data=data,
                         cfg=cfg, access=aw, device=dev).run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = run()
    with obs.tracing():
        traced_wall = run()
        spans = obs.metrics_summary()["spans"]
    with _device_profile() as prof:
        profiled_wall = run()
    out = dict(
        algorithm=PROFILE_ALGORITHM, cell=MAIN_CELL, rounds=PROFILE_ROUNDS,
        wall_s=wall, traced_wall_s=traced_wall,
        profiled_wall_s=profiled_wall,
        spans={k: v for k, v in spans.items() if k.startswith("sim.")},
        **_device_time(prof, wall))
    emit("where_time_goes", **out)
    return out


PORT_KERNEL_NAMES = ("prox_sgd_kernel", "fedagg_kernel", "flash_f32_kernel",
                     "flash_bf16_kernel", "flash_bwd_", "wkv6_")


def _device_profile():
    """`torch.profiler` recording the card's activity only: the kernels
    and the runtime calls that launch them. Host operators are left out:
    recording them cost more than the profiled work itself."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _device_time(prof, wall_s: float) -> dict:
    """Device events of a `torch.profiler` run: their count, the busy
    time (union of their intervals), the idle share against `wall_s` (a
    plain run's wall), time by kernel name (top 12) and the launches,
    time and mean time a launch of each of the port's own kernels. Reads
    the profiler's raw events: `prof.events()` first builds a tree of
    every event, which is slow at hundreds of thousands of events.
    `profile_read_s` is this function's own time."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    device_events = [(e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for name, start, end in device_events:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (end - start) / 1e3
    busy_s = _busy_us([(start / 1e3, end / 1e3)
                       for _, start, end in device_events]) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(
        device_events=len(device_events),
        profile_read_s=time.perf_counter() - t0,
        device_busy_s=busy_s if device_events else None,
        device_idle_share=(1.0 - busy_s / wall_s) if device_events else None,
        device_time_by_name=[dict(name=k[:100], count=n, total_s=us / 1e6)
                             for k, (n, us) in top],
        # Every CUDA launch of the port's own kernels, by kernel.
        port_kernels=[dict(name=k[:100], count=n, total_s=us / 1e6,
                           mean_us=us / n)
                      for k, (n, us) in sorted(by_name.items())
                      if any(s in k for s in PORT_KERNEL_NAMES)])


# ----------------------------------------------------------- cpu vs card
class _OnDevice:
    """A sampler whose draws are made by `inner` (on the CPU) and moved
    to `device`, so the CPU and card runs train on the same minibatches."""

    def __init__(self, inner, device):
        self.inner, self.device = inner, device

    def init(self, workload):
        return self.inner.init(workload).to(self.device)

    def minibatches(self, n_valid, bound, batch_size):
        return self.inner.minibatches(n_valid, bound,
                                      batch_size).to(self.device)

    def codec_uniforms(self, n_clients, layout):
        return self.inner.codec_uniforms(n_clients, layout).to(self.device)


def phase_cpu_vs_card(dev) -> dict:
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    horizon = 4 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    data = synth_femnist(cst.n_sats, seed=0)
    init = params_to_numpy(femnist_mlp_init(
        torch.Generator().manual_seed(0), "cpu"))
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16)
    alg = ALGORITHMS["fedprox"]
    out = dict(algorithm="fedprox", cell="c2s2/g1", rounds=3, tol=1e-4)
    # The host path, then the mesh path (the one-rank group: NCCL for
    # the card's tensors, gloo for the CPU's).
    for execution in ("host", "mesh"):
        runs = {}
        for where, device, sampler in (
                ("cpu", "cpu", TorchSampler(0, "cpu")),
                ("card", dev, _OnDevice(TorchSampler(0, "cpu"), dev))):
            runs[where] = ConstellationSim(
                cst, st, alg, data=data, cfg=cfg, access=aw, device=device,
                sampler=sampler, init_params=init,
                execution=execution).run()
        recs = {k: _records(v) for k, v in runs.items()}
        require(len(recs["card"]) == 3 and recs["card"] == recs["cpu"],
                f"{execution}: RoundRecords differ between the card and "
                "the CPU")
        gap = float(np.abs(_flat_params(runs["card"].final_params)
                           - _flat_params(runs["cpu"].final_params)).max())
        pre = "" if execution == "host" else "mesh_"
        out.update({
            f"{pre}records_identical": True,
            f"{pre}final_params_max_abs_gap": gap,
            f"{pre}accuracy_card": [a for _, _, a in
                                    runs["card"].accuracy_curve],
            f"{pre}accuracy_cpu": [a for _, _, a in
                                   runs["cpu"].accuracy_curve]})
        require(gap <= 1e-4, f"{execution}: final params differ by {gap} "
                             "> 1e-4")
    emit("cpu_vs_card", **out)
    return out


# ------------------------------------------------------------ comms path
COMMS_ROUNDS = 12
ISL_NAMES = ("fedavg_intracc_isl", "fedprox_intracc_isl")
CONNECTIVITY_NAMES = ("fedspace", "ground_assisted", "fedprox_sparse")
LOSSY_CODECS = ("quant_int8", "quant_fp8", "topk_sparse")



def phase_comms_path(dev, setup: dict) -> dict:
    """The ISL, connectivity-aware and codec algorithms on the main-path
    cell, each run traced (`repro_torch.obs`: the comms counters, and each
    span ends in a device sync) with the launch counters zeroed just
    before it and read just after."""
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=COMMS_ROUNDS, horizon_s=MAIN_HORIZON_S,
                    eval_every=5)
    runs = [(name, ALGORITHMS[name], {}) for name in ISL_NAMES
            + CONNECTIVITY_NAMES]
    runs += [(f"fedprox_{c}", spaceify(FedProxSat(), codec=c), {})
             for c in LOSSY_CODECS]
    runs.append(("fedprox_intracc_isl+LinkBudget",
                 ALGORITHMS["fedprox_intracc_isl"],
                 dict(link_model=LinkBudget())))
    out_runs = []
    totals = {"prox_sgd": 0, "fedagg": 0}
    for label, alg, kw in runs:
        ops.reset_launches()          # this run's counts start here
        t0 = time.perf_counter()
        with obs.tracing():
            sim = ConstellationSim(cst, st, alg, data=data, cfg=cfg,
                                   access=aw, device=dev, **kw)
            res = sim.run()
            torch.cuda.synchronize()
            counters = obs.metrics_summary()["counters"]
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for k in totals:
            totals[k] += launches[k]
        relays = sum(1 for r in res.rounds for x in r.relays if x >= 0)
        row = dict(
            run=label, algorithm=res.algorithm, rounds=res.n_rounds,
            wall_s=wall, launches=launches,
            accuracy=[a for _, _, a in res.accuracy_curve],
            relays=relays,
            relay_hops=sum(h for r in res.rounds for h in r.relay_hops),
            comms_bytes=sum(r.total_comms_bytes for r in res.rounds),
            wire_bytes_saved=sum(r.wire_bytes_saved for r in res.rounds),
            codec_error=counters.get("comms.codec_error"),
            encoded_bytes=counters.get("comms.encoded_bytes"),
            plan=None if sim.plan is None else dict(
                isl_edges=len(sim.plan.isl),
                isl_windows=sum(len(e) for e in sim.plan.isl.values())))
        out_runs.append(row)
        print(json.dumps({"phase": "comms_path_run", **row}), flush=True)
        require(res.n_rounds >= 10,
                f"{label}: {res.n_rounds} rounds (< 10) in 2 days")
        require(launches["prox_sgd"] > 0 and launches["fedagg"] > 0,
                f"{label}: a kernel was never launched: {launches}")
        require(sim.device.type == "cuda", f"{label}: not on the card")
        _check_final_params(label, res)
        require(all(math.isfinite(a) for a in row["accuracy"]),
                f"{label}: accuracy not finite")
        if alg.isl:
            require(relays >= 1, f"{label}: no relayed return")
        if alg.codec != "identity":
            require(row["wire_bytes_saved"] > 0
                    and row["codec_error"] is not None
                    and row["codec_error"] > 0,
                    f"{label}: the codec saved no bytes or changed nothing")
    out = dict(cell=MAIN_CELL, horizon_days=MAIN_HORIZON_S / 86400.0,
               max_rounds=COMMS_ROUNDS, runs=out_runs, launches=totals)
    emit("comms_path", **{k: v for k, v in out.items() if k != "runs"},
         walls_s={r["run"]: r["wall_s"] for r in out_runs})
    return out


SCALE_PLANES, SCALE_SATS = 32, 32   # 1,024 satellites (bench_scale.py)
SCALE_HORIZON_S = 86400.0
SCALE_MAX_HOPS = 3
# Threshold-tie band of the ISL distance tests (tests/test_torch_comms.py).
ISL_TIE_M = 50.0


def _route_stats(plan, n_sats: int, n_bytes: float) -> dict:
    t0 = time.perf_counter()
    routes = batch_earliest_arrival(plan, list(range(n_sats)), 0.0,
                                    n_bytes, max_hops=SCALE_MAX_HOPS)
    wall = time.perf_counter() - t0
    reached = [r for r in routes if r is not None]
    hops = np.array([r.isl_hops for r in reached])
    arrivals = np.array([r.arrival_s for r in reached])
    return dict(route_s=wall, reach_frac=len(reached) / n_sats,
                relay_frac=float((hops > 0).mean()) if reached else None,
                mean_hops=float(hops.mean()) if reached else None,
                mean_arrival_h=float(arrivals.mean()) / 3600
                if reached else None)


def phase_comms_scale(dev) -> dict:
    """`benchmarks/bench_scale.py`'s 1,024-satellite plan through the
    port: windows on the card, plan, re-rating and batch routing on the
    host (numpy), each stage's wall; then the card's ISL visibility grid
    against the CPU's, sample by sample."""
    cst, st = WalkerStar(SCALE_PLANES, SCALE_SATS), station_subnetwork(13)
    walls = {}
    t0 = time.perf_counter()
    aw = compute_access_windows(cst, st, horizon_s=SCALE_HORIZON_S,
                                device=dev)
    walls["access_windows"] = time.perf_counter() - t0
    topo = isl.ISLTopology.walker_grid(cst, cross_plane=True, seam_k=2)
    t0 = time.perf_counter()
    iw = compute_isl_windows(cst, topo, horizon_s=SCALE_HORIZON_S,
                             device=dev)
    walls["isl_windows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_contact_plan(aw, iw, ConstantRate(), constellation=cst,
                              stations=st, cache_geometry=True)
    walls["contact_plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_b = plan.rerate(LinkBudget())
    walls["rerate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.tables()
    plan_b.tables()
    walls["window_tables"] = time.perf_counter() - t0
    n_bytes = HardwareModel().model_bytes
    routes = {"const": _route_stats(plan, cst.n_sats, n_bytes),
              "budget": _route_stats(plan_b, cst.n_sats, n_bytes)}

    # The card's ISL grid against the CPU's over the whole day.
    el = cst.elements()
    ei = torch.tensor([i for i, _ in topo.edges])
    ej = torch.tensor([j for _, j in topo.edges])
    n_steps = int(np.ceil(SCALE_HORIZON_S / iw.dt_s)) + 1
    t = torch.as_tensor(np.arange(n_steps) * iw.dt_s, dtype=torch.float32)
    reach = isl.DEFAULT_ISL_MAX_RANGE_KM * 1e3
    t0 = time.perf_counter()
    card = isl.isl_visibility_grid(el, ei.to(dev), ej.to(dev), t.to(dev),
                                   reach).cpu()
    torch.cuda.synchronize()
    walls["isl_grid_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = isl.isl_visibility_grid(el, ei, ej, t, reach)
    walls["isl_grid_cpu"] = time.perf_counter() - t0
    min_r, rng = isl.isl_margins(el, ei, ej, t)
    diff = cpu != card
    tie = (((min_r - (isl.R_EARTH + isl.ATMOSPHERE_PAD_M)).abs()
            <= ISL_TIE_M) | ((rng - reach).abs() <= ISL_TIE_M))
    not_ties = int((diff & ~tie).sum())
    out = dict(
        sats=cst.n_sats, stations=len(st), horizon_days=1.0,
        isl_edges=topo.n_edges,
        isl_windows=sum(len(s) for s, _ in iw.per_edge),
        ground_windows=sum(len(s) for s, _ in aw.per_sat),
        plan_isl_edges=len(plan.isl), walls_s=walls, routes=routes,
        isl_grid_samples=int(diff.numel()),
        isl_grid_visible_share=float(cpu.float().mean()),
        isl_grid_differing_samples=int(diff.sum()),
        isl_grid_differing_not_ties=not_ties, tie_m=ISL_TIE_M)
    emit("comms_scale", **out)
    require(not_ties == 0, f"{not_ties} ISL samples differ between the "
            "card and the CPU away from a threshold tie")
    require(routes["const"]["reach_frac"] > 0.9
            and routes["const"]["relay_frac"] > 0,
            f"routing reached too little: {routes}")
    return out


def phase_comms_cpu_vs_card(dev) -> dict:
    """fedprox_intracc_isl and fedprox with each lossy codec (int8, fp8,
    top-k) on c1s10/g1 over 2 days (a dense plane whose ISL ring relays),
    4 clients a round, on the card and on the CPU: one set of access and
    ISL windows (one contact plan), init params, minibatch draws and
    codec uniforms; then the fp8 round trip's log2 ties."""
    cst, st = WalkerStar(1, 10), station_subnetwork(1)
    horizon = 2 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    iw = compute_isl_windows(cst, horizon_s=horizon, device="cpu")
    plan = build_contact_plan(aw, iw)
    data = synth_femnist(cst.n_sats, seed=0)
    init = params_to_numpy(femnist_mlp_init(
        torch.Generator().manual_seed(0), "cpu"))
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16, clients_per_round=4)
    out = {}
    runs_to_check = [("fedprox_intracc_isl",
                      ALGORITHMS["fedprox_intracc_isl"])]
    runs_to_check += [(f"fedprox_{c}", spaceify(FedProxSat(), codec=c))
                      for c in LOSSY_CODECS]
    for label, alg in runs_to_check:
        runs = {}
        for where, device, sampler in (
                ("cpu", "cpu", TorchSampler(0, "cpu")),
                ("card", dev, _OnDevice(TorchSampler(0, "cpu"), dev))):
            runs[where] = ConstellationSim(
                cst, st, alg, data=data, cfg=cfg, access=aw,
                contact_plan=plan if alg.isl else None, device=device,
                sampler=sampler, init_params=init).run()
        recs = {k: _records(v) for k, v in runs.items()}
        flat = {k: _flat_params(v.final_params) for k, v in runs.items()}
        gap = np.abs(flat["card"] - flat["cpu"])
        accs = {k: [a for _, _, a in v.accuracy_curve]
                for k, v in runs.items()}
        row = dict(
            rounds=len(recs["card"]),
            records_identical=recs["card"] == recs["cpu"],
            relays=sum(1 for r in runs["card"].rounds
                       for x in r.relays if x >= 0),
            final_params_max_abs_gap=float(gap.max()),
            params_over_1e5=int((gap > 1e-5).sum()),
            relative_l2=float(np.linalg.norm(flat["card"] - flat["cpu"])
                              / np.linalg.norm(flat["cpu"])),
            accuracy_card=accs["card"], accuracy_cpu=accs["cpu"])
        out[label] = row
        require(row["rounds"] == 3 and row["records_identical"],
                f"{label}: RoundRecords differ between the card and the CPU")
        if alg.isl:
            require(row["relays"] >= 1, f"{label}: no relayed return")
            require(row["final_params_max_abs_gap"] <= 1e-4,
                    f"{label}: final params differ by "
                    f"{row['final_params_max_abs_gap']} > 1e-4")
        else:
            far, rel = CODEC_BOUNDS[alg.codec]
            row.update(bound_params_over_1e5=far, bound_relative_l2=rel)
            require(row["params_over_1e5"] <= far
                    and row["relative_l2"] <= rel
                    and all(abs(a - b) <= 2 / 256 for a, b in
                            zip(accs["card"], accs["cpu"])),
                    f"{label}: card and CPU outside the codec bounds: {row}")
    out["fp8_roundtrip_log2_ties"] = _fp8_tie_flips(dev)
    emit("comms_cpu_vs_card", cell="c1s10/g1", **out)
    return out


# Card vs CPU bounds of a trained lossy-codec run (3 rounds x 4 clients x
# 46,639 params on c1s10/g1): (params more than 1e-5 apart, relative L2 of
# the final params' gap). Training on the card and on the CPU is ~1e-7
# apart (the identity runs), so each delta entering the codec differs by
# about an ulp of the params.
# - quant_int8 (tests/test_torch_engine.py::
#   test_quant_int8_training_within_codec_bounds): an element rounds to
#   the other level when its uniform falls between the two fractional
#   parts, probability |gap| / step with step = amax / 127 of its leaf,
#   ~1e-4 a rounding; a flip moves the global model by its client's
#   weight (~1/4) of a step, and flips do not compound (every round
#   re-anchors on the global model): <= 100 params, relative L2 <= 1e-4.
# - quant_fp8: the same mechanism on a relative grid; an element's step is
#   2^(e - 3) of its leaf's amax-normalized exponent, as fine as amax/512
#   at the e4m3 floor, so a rounding flips up to 4x as often as int8's
#   (amax/127 against amax/512) while each flip moves its element by a
#   step no larger than int8's on average: <= 400 params (4x), relative
#   L2 <= 2e-4 (sqrt(4) = 2x). Where log2 ties, the card's and CPU's
#   round trips differ on identical inputs too (one step, counted in
#   `fp8_roundtrip_log2_ties`), inside the same bound.
# - topk_sparse: deterministic; a client's kept set differs only where an
#   element's magnitude lies within the ~1e-7 training gap of its row's
#   k-th largest (~5e-3 expected swaps a client-round at 46,639 elements
#   spread over ~1e-3); a swap moves two elements by about the threshold
#   magnitude times the client's weight: <= 10 params (a few swaps),
#   relative L2 <= 1e-4 (a few threshold-size moves against a norm ~15).
CODEC_BOUNDS = {"quant_int8": (100, 1e-4), "quant_fp8": (400, 2e-4),
                "topk_sparse": (10, 1e-4)}


def _fp8_tie_flips(dev) -> dict:
    """One fp8 round trip of a 10-client femnist_mlp stack on the card and
    on the CPU from the same params, anchors and uniforms (the inputs of
    tests/test_torch_cuda.py::test_card_codec_roundtrip_matches_cpu): the
    elements that differ, each required to be a log2 tie (log2 of its
    normalized magnitude within an ulp of an integer)."""
    from repro_torch.comms.codec import CODECS, client_roundtrip
    from repro_torch.params import FEMNIST_MLP
    g = torch.Generator().manual_seed(3)
    params = torch.randn((10, P_MLP), generator=g) * 0.1
    anchor = params + torch.randn((10, P_MLP), generator=g) * 1e-3
    u = torch.rand((10, P_MLP), generator=g)
    codec = CODECS["quant_fp8"]
    cpu = client_roundtrip(codec, params, anchor, FEMNIST_MLP, u)
    card = client_roundtrip(codec, params.to(dev), anchor.to(dev),
                            FEMNIST_MLP, u.to(dev)).cpu()
    diff = cpu != card
    segs = torch.split(params - anchor, FEMNIST_MLP.sizes, dim=-1)
    v = torch.cat([x / x.abs().amax(-1, keepdim=True) for x in segs], -1)
    lg = torch.log2(v.abs().clamp(min=2.0 ** -30))
    near = (lg - lg.round()).abs() <= torch.finfo(torch.float32).eps * \
        lg.abs().clamp(min=1.0)
    not_ties = int((diff & ~near).sum())
    require(not_ties == 0, f"fp8 round trip: {not_ties} elements differ "
            "between the card and the CPU away from a log2 tie")
    return dict(elements=int(diff.numel()), differing=int(diff.sum()),
                ties=int(near.sum()))


# -------------------------------------------------------------- cnn path
CNN_ROUNDS = 10
CNN_NAMES = ("fedavg", "fedprox", "fedbuff")


def phase_cnn_path(dev, setup: dict) -> dict:
    """The paper's CNN (`femnist_cnn`, 47,887 params, derived cost model)
    through the loop path on the main-path cell, each run with the launch
    counters zeroed just before it and read just after; then card vs CPU
    on c2s2/g1."""
    cst, st, data, aw = (setup[k] for k in ("cst", "st", "data", "aw"))
    cfg = SimConfig(max_rounds=CNN_ROUNDS, horizon_s=MAIN_HORIZON_S,
                    eval_every=5)
    runs = []
    totals = {"prox_sgd": 0, "fedagg": 0}
    for name in CNN_NAMES:
        ops.reset_launches()          # this run's counts start here
        t0 = time.perf_counter()
        sim = ConstellationSim(cst, st, ALGORITHMS[name], data=data,
                               cfg=cfg, access=aw, workload="femnist_cnn",
                               device=dev)
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for k in totals:
            totals[k] += launches[k]
        accs = [a for _, _, a in res.accuracy_curve]
        runs.append(dict(algorithm=name, rounds=res.n_rounds, wall_s=wall,
                         launches=launches, accuracy=accs,
                         epoch_mflops=sim.hw.epoch_mflops,
                         model_bytes=sim.hw.model_bytes))
        require(res.n_rounds >= 5,
                f"cnn {name}: {res.n_rounds} rounds (< 5) in 2 days")
        require(launches["prox_sgd"] > 0 and launches["fedagg"] > 0,
                f"cnn {name}: a kernel was never launched: {launches}")
        require(sim.device.type == "cuda", f"cnn {name}: not on the card")
        _check_final_params(f"cnn {name}", res, P_CNN)
        require(bool(accs) and all(math.isfinite(a) for a in accs),
                f"cnn {name}: accuracy not finite: {accs}")
    out = dict(cell=MAIN_CELL, horizon_days=MAIN_HORIZON_S / 86400.0,
               max_rounds=CNN_ROUNDS, runs=runs, launches=totals,
               cpu_vs_card=_cnn_cpu_vs_card(dev))
    emit("cnn_path", **out)
    return out


def _one_step_gap(dev, wl, data, init: torch.Tensor) -> float:
    """One local step (gradient + one prox_sgd launch, mu 0.1) of a
    4-client stack from the same params and minibatch, card vs CPU."""
    idx = torch.randint(0, 200, (4, 1, 32),
                        generator=torch.Generator().manual_seed(1))
    outs = []
    for device in ("cpu", dev):
        update = vmapped_client_update(wl.loss_fn, lr=0.05, batch_size=32,
                                       max_steps=1, layout=wl.layout)
        p0 = init.to(device)
        outs.append(update(p0.expand(4, -1), p0,
                           torch.as_tensor(data.x[:4], device=device),
                           torch.as_tensor(data.y[:4], device=device).long(),
                           [1] * 4, 0.1, idx.to(device)).cpu())
    return float((outs[0] - outs[1]).abs().max())


def _cnn_cpu_vs_card(dev) -> dict:
    """fedprox on femnist_cnn, c2s2/g1, 3 rounds, on the card and on the
    CPU with the same access windows, init params and minibatch draws.

    The RoundRecords must be identical and one local step within 1e-4.
    The trained run's params gap is reported, not bounded: the CNN's
    max-pools route a window's gradient to its largest input, and two
    inputs within an ulp of each other (conv outputs that the card's and
    the CPU's matmuls round differently) send it to different positions,
    a step apart by ~lr * 1e-3; later steps amplify that. The same run on
    the card from params one ulp away (`ulp_envelope_gap`) shows how far
    two runs that differ only in rounding drift apart."""
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    horizon = 4 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    data = synth_femnist(cst.n_sats, seed=0)
    wl = get_workload("femnist_cnn")
    init_t = femnist_cnn_init(torch.Generator().manual_seed(0), "cpu")
    init = params_to_numpy(init_t, FEMNIST_CNN)
    nudged = params_to_numpy(torch.nextafter(init_t, torch.tensor(np.inf)),
                             FEMNIST_CNN)
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16)
    alg = ALGORITHMS["fedprox"]
    runs = {}
    for where, device, sampler, start in (
            ("cpu", "cpu", TorchSampler(0, "cpu"), init),
            ("card", dev, _OnDevice(TorchSampler(0, "cpu"), dev), init),
            ("card_ulp", dev, _OnDevice(TorchSampler(0, "cpu"), dev),
             nudged)):
        runs[where] = ConstellationSim(
            cst, st, alg, data=data, cfg=cfg, access=aw, device=device,
            workload="femnist_cnn", sampler=sampler,
            init_params=start).run()
    recs = {k: _records(v) for k, v in runs.items()}
    require(len(recs["card"]) == 3 and recs["card"] == recs["cpu"],
            "cnn: RoundRecords differ between the card and the CPU")
    flat = {k: _flat_params(v.final_params) for k, v in runs.items()}
    step_gap = _one_step_gap(dev, wl, data, init_t)
    out = dict(algorithm="fedprox", cell="c2s2/g1", rounds=3,
               records_identical=True, one_step_max_abs_gap=step_gap,
               tol=1e-4,
               final_params_max_abs_gap=float(np.abs(
                   flat["card"] - flat["cpu"]).max()),
               ulp_envelope_gap=float(np.abs(
                   flat["card"] - flat["card_ulp"]).max()),
               accuracy_card=[a for _, _, a in runs["card"].accuracy_curve],
               accuracy_cpu=[a for _, _, a in runs["cpu"].accuracy_curve])
    require(step_gap <= 1e-4,
            f"cnn: one local step differs by {step_gap} > 1e-4")
    return out


# --------------------------------------------------------- batched sweep
SWEEP_HORIZON_S = 7 * 86400.0        # cut from 90 days
SWEEP_ROUNDS = 10                    # cut from 500
SWEEP_CLUSTERS = (1, 2, 5, 10)
SWEEP_SATS = (1, 2, 5, 10)
SWEEP_STATIONS = (1, 2, 3, 5, 10, 13)
# Every 32nd cell of the 768 (alg-major order): 3 cells per algorithm,
# 8 algorithms, from c1s2/g2 to c5s10/g13.
SWEEP_SAMPLE = slice(7, None, 32)
TRAIN_ALGS = ("fedavg", "fedprox", "fedavg_sched", "fedbuff")
TRAIN_CLUSTERS, TRAIN_SATS, TRAIN_STATIONS = (2, 10), (2, 10), (1, 13)
TRAIN_ROUNDS = 5                     # cut from 20 to fit the time limit
TRAIN_HORIZON_S = 2 * 86400.0


def _sweep_windows(dev, constellations, horizon_s: float) -> dict:
    """Access windows on the card for each (clusters, sats) at the full
    13-station network; smaller networks by `subset` (the first-n ladder),
    as benchmarks/common.py derives them."""
    out = {}
    for cl, sp in constellations:
        full = compute_access_windows(WalkerStar(cl, sp),
                                      station_subnetwork(13),
                                      horizon_s=horizon_s, device=dev)
        for g in SWEEP_STATIONS:
            out[(cl, sp, g)] = full if g == 13 else full.subset(g)
    torch.cuda.synchronize()
    return out


def _expected_launches(results, sims) -> dict:
    """The kernels' launches a batched training run must make: one
    `prox_sgd` per local step of each round (the round's largest client
    budget over the batch) and one `fedagg` per round."""
    n_rounds = max(len(r.rounds) for r in results)
    steps = 0
    for rnd in range(n_rounds):
        steps += max(
            (client_steps(int(sim.data.n[k]), e, sim.cfg.batch_size,
                          sim.cfg.max_steps)
             for res, sim in zip(results, sims) if rnd < len(res.rounds)
             for k, e in zip(res.rounds[rnd].participants,
                             res.rounds[rnd].epochs)), default=0)
    return {"prox_sgd": steps, "fedagg": n_rounds}


def _train_cells_sims(dev, workload: str, aws: dict, datas: dict,
                      cells) -> list:
    cfg = SimConfig(max_rounds=TRAIN_ROUNDS, horizon_s=TRAIN_HORIZON_S,
                    eval_every=5)
    return [ConstellationSim(WalkerStar(cl, sp), station_subnetwork(g),
                             ALGORITHMS[a], data=datas[cl * sp], cfg=cfg,
                             access=aws[(cl, sp, g)], workload=workload,
                             device=dev)
            for a, cl, sp, g in cells]


def _compare_paths(loop, batched) -> dict:
    """Loop vs batched results: records must be identical; the gaps of
    final params and accuracy curves are returned."""
    for lr, br in zip(loop, batched):
        require(_records(lr) == _records(br) and len(lr.rounds) > 0,
                f"{lr.algorithm}: batched RoundRecords differ from the loop "
                "path's")
    params_gap = max(float(np.abs(_flat_params(lr.final_params)
                                  - _flat_params(br.final_params)).max())
                     for lr, br in zip(loop, batched))
    curve_gap = 0.0
    for lr, br in zip(loop, batched):
        cl = {i: a for i, _, a in lr.accuracy_curve}
        cb = {i: a for i, _, a in br.accuracy_curve}
        require(set(cl) == set(cb), f"{lr.algorithm}: curves cover other "
                f"rounds: {sorted(cl)} vs {sorted(cb)}")
        curve_gap = max([curve_gap] + [abs(cl[i] - cb[i]) for i in cl])
    return dict(final_params_max_abs_gap=params_gap,
                accuracy_max_abs_gap=curve_gap)


def phase_batched_sweep(dev) -> dict:
    """(a) The paper's Table-1 grid (8 algorithms x 4 x 4 x 6 = 768
    scenarios) as one timing-only BatchedSweep, a fixed sample held to the
    loop path bitwise; (b) 32 scenarios trained on femnist_cnn through the
    batched executor (launches counted from 0 just before it; then once
    more under torch.profiler), then through the loop path: identical
    records, final params and curves within 1e-4; (c) a small batch on
    the card and on the CPU."""
    out = {}
    # (a) timing only.
    walls = {}
    grid = [(a, cl, sp, g) for a in TABLE1_NAMES for cl in SWEEP_CLUSTERS
            for sp in SWEEP_SATS for g in SWEEP_STATIONS]
    t0 = time.perf_counter()
    aws = _sweep_windows(dev, [(cl, sp) for cl in SWEEP_CLUSTERS
                               for sp in SWEEP_SATS], SWEEP_HORIZON_S)
    walls["access_windows"] = time.perf_counter() - t0
    cfg = SimConfig(max_rounds=SWEEP_ROUNDS, horizon_s=SWEEP_HORIZON_S,
                    train=False)

    def timing_sim(a, cl, sp, g):
        return ConstellationSim(WalkerStar(cl, sp), station_subnetwork(g),
                                ALGORITHMS[a], cfg=cfg,
                                access=aws[(cl, sp, g)], device=dev)

    t0 = time.perf_counter()
    sims = [timing_sim(*c) for c in grid]
    walls["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with obs.tracing():
        results = BatchedSweep(sims, [f"{a}/c{cl}s{sp}/g{g}"
                                      for a, cl, sp, g in grid]).run()
        spans = obs.metrics_summary()["spans"]
    walls["batched"] = time.perf_counter() - t0
    sample = grid[SWEEP_SAMPLE]
    t0 = time.perf_counter()
    loop = [timing_sim(*c).run() for c in sample]
    walls["loop_sample"] = time.perf_counter() - t0
    picked = results[SWEEP_SAMPLE]
    for c, lr, br in zip(sample, loop, picked):
        require(_records(lr) == _records(br) and len(lr.rounds) > 0,
                f"{c}: batched timing differs from the loop path's")
    fed = sum(1 for c in grid if c[1] * c[2] >= 2)
    require(len(results) == len(grid) == 768 and fed == 720
            and all(len(r.rounds) == 0 for c, r in zip(grid, results)
                    if c[1] * c[2] < 2), "the grid's results are incomplete")
    out["timing"] = dict(
        scenarios=len(grid), federating=fed,
        horizon_days=SWEEP_HORIZON_S / 86400.0, max_rounds=SWEEP_ROUNDS,
        rounds=sum(len(r.rounds) for r in results),
        lockstep_planned=sum(1 for sim in sims if _fast_plannable(sim)),
        scalar_twins=spans.get("sim.batched.plan_scalar", {}).get("count"),
        sample=[f"{a}/c{cl}s{sp}/g{g}" for a, cl, sp, g in sample],
        sample_records_identical=True, walls_s=walls)
    print(json.dumps({"phase": "batched_sweep_timing", **out["timing"]}),
          flush=True)
    del sims, results

    # (b) training on femnist_cnn, then the same cells on femnist_mlp.
    cells = [(a, cl, sp, g) for a in TRAIN_ALGS for cl in TRAIN_CLUSTERS
             for sp in TRAIN_SATS for g in TRAIN_STATIONS]
    t0 = time.perf_counter()
    aws = _sweep_windows(dev, [(cl, sp) for cl in TRAIN_CLUSTERS
                               for sp in TRAIN_SATS], TRAIN_HORIZON_S)
    datas = {cl * sp: synth_femnist(cl * sp, seed=0)
             for cl in TRAIN_CLUSTERS for sp in TRAIN_SATS}
    setup_s = time.perf_counter() - t0
    train = {}
    for wl in ("femnist_cnn",):
        row = dict(scenarios=len(cells), rounds=TRAIN_ROUNDS,
                   horizon_days=TRAIN_HORIZON_S / 86400.0)
        sims = _train_cells_sims(dev, wl, aws, datas, cells)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()            # the batched run's counts start here
        t0 = time.perf_counter()
        batched = BatchedSweep(sims).run()
        torch.cuda.synchronize()
        row["batched_wall_s"] = time.perf_counter() - t0
        row["launches"] = launches = dict(ops.LAUNCHES)
        row["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
        want = _expected_launches(batched, sims)
        row["expected_launches"] = want
        require(launches["prox_sgd"] == want["prox_sgd"]
                and launches["fedagg"] == want["fedagg"],
                f"{wl}: the batch launched {launches}, expected {want}: one "
                "prox_sgd a local step and one fedagg a round")
        for res in batched:
            _check_final_params(f"{wl} batched {res.algorithm}", res,
                                get_workload(wl).n_params)
            require(all(math.isfinite(a) for _, _, a in res.accuracy_curve)
                    and res.accuracy_curve[-1][0] == res.rounds[-1].idx,
                    f"{wl} batched {res.algorithm}: bad accuracy curve")
        if wl == "femnist_cnn":
            sims = _train_cells_sims(dev, wl, aws, datas, cells)
            with _device_profile() as prof:
                BatchedSweep(sims).run()
                torch.cuda.synchronize()
            row["profiled"] = _device_time(prof, row["batched_wall_s"])
            del prof
        t0 = time.perf_counter()
        loop = [sim.run() for sim in
                _train_cells_sims(dev, wl, aws, datas, cells)]
        torch.cuda.synchronize()
        row["loop_wall_s"] = time.perf_counter() - t0
        row.update(_compare_paths(loop, batched), records_identical=True)
        require(row["final_params_max_abs_gap"] <= 1e-4
                and row["accuracy_max_abs_gap"] <= 1e-4,
                f"{wl}: batched and loop differ: {row}")
        train[wl] = row
        print(json.dumps({"phase": f"batched_sweep_{wl}", **row}),
              flush=True)
    out["train"] = train
    out["train_setup_s"] = setup_s
    out["cpu_vs_card"] = _batched_cpu_vs_card(dev)
    emit("batched_sweep", card=smi_line(),
         **{k: v for k, v in out.items() if k not in ("timing", "train")},
         timing_walls_s=out["timing"]["walls_s"],
         walls_s={wl: dict(batched=r["batched_wall_s"],
                           loop=r["loop_wall_s"])
                  for wl, r in train.items()})
    return out


def _batched_cpu_vs_card(dev) -> dict:
    """fedavg, fedprox and fedbuff as one batch on c2s2/g1, 3 rounds, on
    the card and on the CPU with the same windows and draws: identical
    records; femnist_mlp params within 1e-4 (the main path's card-vs-CPU
    limit); femnist_cnn's gap reported (see `_cnn_cpu_vs_card`)."""
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    horizon = 4 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    data = synth_femnist(cst.n_sats, seed=0)
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16)
    out = {}
    for wl in ("femnist_mlp", "femnist_cnn"):
        runs = {}
        for where, device in (("cpu", "cpu"), ("card", dev)):
            sims = [ConstellationSim(
                cst, st, ALGORITHMS[a], data=data, cfg=cfg, access=aw,
                device=device, workload=wl,
                sampler=(TorchSampler(0, "cpu") if where == "cpu" else
                         _OnDevice(TorchSampler(0, "cpu"), dev)))
                    for a in CNN_NAMES]
            runs[where] = BatchedSweep(sims).run()
        for c, b in zip(runs["cpu"], runs["card"]):
            require(_records(c) == _records(b) and len(b.rounds) == 3,
                    f"{wl} {b.algorithm}: batched records differ between "
                    "the card and the CPU")
        gap = max(float(np.abs(_flat_params(c.final_params)
                               - _flat_params(b.final_params)).max())
                  for c, b in zip(runs["cpu"], runs["card"]))
        out[wl] = dict(records_identical=True, final_params_max_abs_gap=gap)
        if wl == "femnist_mlp":
            require(gap <= 1e-4, f"batched {wl}: card and CPU params "
                    f"differ by {gap} > 1e-4")
    return dict(cell="c2s2/g1", rounds=3, algorithms=list(CNN_NAMES), **out)


# ------------------------------------------------------------ lm kernels
# (rtol, atol). In bf16 both sides round one f32 result, so they differ
# by at most one bf16 step: 2**-7 * |want| < 8e-3 * |want|.
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (8e-3, 1e-3)}
WKV6_TOL = 2e-4
# hymba-1.5b serving: batch 4, 2048-token prompts, 25 query heads on 5 KV
# heads of 64; its SSD heads: 50 heads, state 16, head dim 64.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS = 4, 2048, 32, 8
# rwkv6-1.6b at full width, served and trained; grok-1 at full width with
# its depth cut to MOE_LAYERS (the whole model does not fit one card).
RWKV_ARCH = "rwkv6-1.6b"
MOE_ARCH, MOE_LAYERS, MOE_SOFTCAP = "grok-1-314b", 2, 30.0
# deepseek-v3 at full width with its depth cut to one dense and one MoE
# MLA layer (the whole 671 B model does not fit one card); its MLA heads:
# 128 query and key heads of 192 dims (nope 128 + rope 64), values 128.
MLA_ARCH, MLA_D, MLA_DV = "deepseek-v3-671b", 192, 128
# lm_moe_tiny's model: deepseek-v3 reduced to 3 dense MLA layers and 1
# MoE layer of 8 experts, heads of (96, 64).
MLA_TINY = dict(n_layers=4, n_experts=8)
# whisper-medium at full width, served and trained: 1,500 frames (30 s of
# audio) a request; a 224-token prompt, half of its 448-token text
# context; trained at batch 4 x 448 text tokens.
AUDIO_ARCH, AUDIO_FRAMES, AUDIO_PROMPT = "whisper-medium", 1500, 224
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ = 4, 448
# llava-next-mistral-7b at full width, served: 2,880 prefix embeddings
# (LLaVA-NeXT's AnyRes worst case, 5 x 576 patches) + 2,048 text tokens,
# window 4,096; trained at every published width with its depth cut to
# VLM_TRAIN_LAYERS of 32 (with f32 Adam moments the whole model needs
# ~87 GB), batch 2.
VLM_ARCH, VLM_PREFIX, VLM_WINDOW = "llava-next-mistral-7b", 2880, 4096
VLM_TRAIN_LAYERS = 4
# deepseek-v3 trained at every published width with its depth cut to its
# 3 dense MLA layers: 4,530,494,464 params as the reference's `eval_shape`
# counts them, 9.06 GB of bf16 weights, 9.06 GB of gradients and 36.2 GB
# of f32 Adam moments. One routed layer alone is 11.5 B params (~138 GB
# with its moments), so no MoE layer fits beside an optimizer on one card.
MLA_TRAIN_LAYERS, MLA_TRAIN_PARAMS = 3, 4_530_494_464


def _flash_pairs(S: int, causal: bool, window: int | None,
                 Sk: int | None = None) -> int:
    """(q, k) pairs that the masks leave, queries at 0..S-1 and keys at
    0..Sk-1 (Sk = S unless given: cross-attention, with no mask)."""
    if Sk is not None and Sk != S:
        return S * Sk
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    hi = q + 1 if causal else np.full(S, S)
    return int((hi - lo).sum())


def _sdpa_call(q, k, v, causal: bool, window: int | None):
    """scaled_dot_product_attention over the same masks (is_causal, or the
    window as an explicit mask), v as given or, where SDPA refuses a
    value head dim Dv below D, zero-padded to D (the output's extra
    columns are zero). Returns (call, the backend SDPA picks, note)."""
    from torch.nn.attention import SDPBackend
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(is_causal=causal, enable_gqa=True)
    if window is not None:
        pos = torch.arange(q.shape[2], device=q.device)
        lag = pos[:, None] - pos[None, :]
        kw = dict(attn_mask=(lag < window) & ((lag >= 0) if causal
                                              else True), enable_gqa=True)
    note = None
    try:
        sdpa(q, k, v, **kw)
    except RuntimeError:                 # Dv != D refused: pad v to D
        v = torch.nn.functional.pad(v, (0, q.shape[-1] - v.shape[-1]))
        note = f"v zero-padded from Dv to D = {q.shape[-1]}"
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    backend = names.get(int(torch._fused_sdp_choice(q, k, v, **kw)))
    return (lambda: sdpa(q, k, v, **kw)), backend, note


def check_flash(dev, case: str, B: int, H: int, KV: int, S: int, D: int,
                dtype: str, causal: bool = True, window: int | None = None,
                softcap: float | None = None,
                sdpa_without_softcap: bool = False,
                Dv: int | None = None, Sk: int | None = None) -> dict:
    """The forward kernel against its plain version, values of head dim
    Dv (D unless given: MLA's is below D), keys of length Sk (S unless
    given: cross-attention's, non-causal); the yardstick is
    scaled_dot_product_attention where it computes the same masks (with
    `sdpa_without_softcap`, a softcapped case is timed against SDPA with
    no softcap, which it does not take: `library_note` says so), and the
    backend it picked."""
    Dv, Sk = Dv or D, Sk or S
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(B * H * S + D + Sk - S)
    q = torch.randn((B, H, S, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, KV, Sk, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, KV, Sk, Dv), generator=g, device=dev).to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention_op(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _max_err(got, want, *FLASH_TOL[dtype])
    del got, want
    pairs = B * H * _flash_pairs(S, causal, window, Sk)
    n_bytes = (B * H * S + B * KV * Sk) * (D + Dv) * q.element_size()
    # q.k (2 D flops) and p v (2 Dv) a counted pair.
    b_ms, b_by = bound_ms(n_bytes, 2 * (D + Dv) * pairs,
                          BF16_FLOPS_PER_S if dtype == "bfloat16"
                          else F32_FLOPS_PER_S)
    # One PyTorch call computing the same function (a yardstick only).
    library, backend, note = None, None, None
    if softcap is None or sdpa_without_softcap:
        library, backend, note = _sdpa_call(q, k, v, causal, window)
        if softcap is not None:
            note = "SDPA without softcap"
    return dict(
        name="flash_attention", case=case, B=B, H=H, KV=KV, S=S, Sk=Sk, D=D,
        Dv=Dv,
        dtype=dtype, causal=causal, window=window, softcap=softcap,
        pairs=pairs, max_abs_err=err, rtol=FLASH_TOL[dtype][0],
        atol=FLASH_TOL[dtype][1],
        ms=device_ms(lambda: ops.flash_attention_op(q, k, v, **kw)),
        plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
        library_ms=None if library is None else device_ms(library),
        library_backend=backend, library_note=note,
        bound_ms=b_ms, bound_by=b_by)


def _rwkv_inputs(dev, B: int, H: int, T: int, K: int, g) -> list:
    """r, k, v, logw as the RWKV6 time mix passes them
    (models/lm/rwkv.py): (B, T, H, K) tensors as transposed (B, H, T, K)
    views, logw in the model's range (-exp of -6 .. -1, w0's span)."""
    rnd = lambda: torch.randn((B, T, H, K), generator=g, device=dev)
    lw = -torch.exp(-6.0 + 5.0 * torch.rand((B, T, H, K), generator=g,
                                            device=dev))
    return [t.transpose(1, 2) for t in (rnd(), rnd(), rnd(), lw)]


def check_wkv6(dev, case: str, B: int, H: int, T: int, K: int, V: int,
               chunk: int = 64, strong_decay: bool = False,
               ssd_views: bool = False, rwkv_views: bool = False,
               generic: bool = False) -> dict:
    """With `ssd_views`, the inputs are laid out as the SSD heads pass them
    (models/lm/ssm.py): k broadcast over heads, logw over the state dim
    (stride 0), v a transposed (B, T, H, V) view; with `rwkv_views` as
    the RWKV6 time mix passes them (`_rwkv_inputs`, K = V). `generic`
    launches the build with sizes from the arguments where a fixed build
    exists (16 / 64 x 64 x 64), to compare the two."""
    g = torch.Generator(device=dev).manual_seed(B * H * T + K)
    if rwkv_views:
        r, k, v, lw = _rwkv_inputs(dev, B, H, T, K, g)
        s0 = torch.zeros((B, H, K, V), device=dev)
    else:
        r = torch.randn((B, H, T, K), generator=g, device=dev)
        if ssd_views:
            k = torch.randn((B, 1, T, K), generator=g, device=dev).expand(
                B, H, T, K)
            v = torch.randn((B, T, H, V), generator=g,
                            device=dev).transpose(1, 2)
        else:
            k = torch.randn((B, H, T, K), generator=g, device=dev)
            v = torch.randn((B, H, T, V), generator=g, device=dev)
        if strong_decay:                 # near-total decay every step
            lw = torch.full((B, H, T, K), -5.0, device=dev)
            s0 = torch.zeros((B, H, K, V), device=dev)
        elif ssd_views:
            lw = -0.3 * torch.randn((B, H, T, 1), generator=g,
                                    device=dev).abs().expand(B, H, T, K)
            s0 = torch.zeros((B, H, K, V), device=dev)
        else:
            lw = -0.3 * torch.randn((B, H, T, K), generator=g,
                                    device=dev).abs()
            s0 = torch.randn((B, H, K, V), generator=g, device=dev)
    args = (r, k, v, lw, s0)
    run = (lambda: wkv6(*args, chunk=chunk, generic=True)) if generic \
        else (lambda: ops.wkv6_op(*args, chunk=chunk))
    o, s_final = run()
    want_o, want_s = ref.wkv6_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    err = max(_max_err(o, want_o, WKV6_TOL), _max_err(s_final, want_s,
                                                       WKV6_TOL))
    # Each input read once (a broadcast input's distinct elements), each
    # output written once.
    n_in = sum(x.untyped_storage().nbytes() for x in args)
    n_bytes = n_in + (B * H * T * V + B * H * K * V) * 4
    # The step-by-step recurrence: o = r.S (2KV), S = w S + k v^T (3KV).
    b_ms, b_by = bound_ms(n_bytes, 5 * B * H * T * K * V)
    return dict(
        name="wkv6", case=case, B=B, H=H, T=T, K=K, V=V, chunk=chunk,
        strong_decay=strong_decay, ssd_views=ssd_views,
        rwkv_views=rwkv_views, build="generic" if generic else "fixed"
        if (K, V, chunk) in ((16, 64, 64), (64, 64, 64)) else "generic",
        max_abs_err=err, tol=WKV6_TOL, ms=device_ms(run),
        plain_ms=device_ms(lambda: ref.wkv6_ref(*args, chunk=chunk)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_lm_kernels(dev) -> list[dict]:
    B, S = SERVE_BATCH, SERVE_PROMPT
    rows = []
    for dtype in ("bfloat16", "float32"):
        rows.append(check_flash(dev, "serve_swa", B, 25, 5, S, 64, dtype,
                                window=1024))
        rows.append(check_flash(dev, "serve_full", B, 25, 5, S, 64, dtype))
    # The mask cases of tests/test_kernels.py (its D = 32 GQA case at 64),
    # on both kernels.
    for dtype in ("float32", "bfloat16"):
        for b, h, kv, s, d, causal, window, softcap in (
                (1, 2, 2, 128, 64, True, None, None),
                (2, 4, 2, 128, 64, True, None, None),
                (1, 4, 1, 256, 64, True, 64, None),
                (1, 2, 2, 128, 64, False, None, None),
                (1, 2, 2, 128, 64, True, None, 30.0),
                (1, 2, 1, 64, 128, True, 16, None)):
            rows.append(check_flash(dev, "mask_sweep", b, h, kv, s, d, dtype,
                                    causal, window, softcap))
    rows.append(check_flash(dev, "bf16", 1, 2, 2, 128, 64, "bfloat16"))
    rows.append(check_flash(dev, "ragged_S", B, 25, 5, 1000, 64, "bfloat16",
                            window=256))
    rows.append(check_flash(dev, "mqa_d256", 1, 8, 1, S, 256, "bfloat16"))
    rows.append(check_flash(dev, "gqa_d128", 1, 32, 8, 1024, 128,
                            "bfloat16", window=512))
    rows.append(check_wkv6(dev, "serve", B, 50, S, 16, 64))
    rows.append(check_wkv6(dev, "serve_ssd_views", B, 50, S, 16, 64,
                           ssd_views=True))
    rows.append(check_wkv6(dev, "k64_v64", B, 32, S, 64, 64))
    # rwkv6-1.6b serving: 32 heads of K = V = 64 on the time mix's
    # transposed views, the fixed build and the generic one.
    rows.append(check_wkv6(dev, "rwkv_serve", B, 32, S, 64, 64,
                           rwkv_views=True))
    rows.append(check_wkv6(dev, "rwkv_serve_generic", B, 32, S, 64, 64,
                           rwkv_views=True, generic=True))
    # grok-1 serving: bf16, 48 query heads on 8 KV heads of 128, full
    # causal, logit softcap 30 (SDPA, the yardstick, without it).
    rows.append(check_flash(dev, "grok_serve", B, 48, 8, S, 128, "bfloat16",
                            softcap=MOE_SOFTCAP, sdpa_without_softcap=True))
    rows.append(check_wkv6(dev, "ragged_T", 2, 50, 1000, 16, 64))
    rows.append(check_wkv6(dev, "strong_decay", 1, 1, 256, 32, 32,
                           chunk=128, strong_decay=True))
    # deepseek-v3 serving: bf16, 128 heads of (D, Dv) = (192, 128), full
    # causal; and lm_moe_tiny's launch (128 sequences of 33 tokens, 4
    # heads of (96, 64), f32).
    rows.append(check_flash(dev, "mla_serve", B, 128, 128, S, MLA_D,
                            "bfloat16", Dv=MLA_DV))
    n = LM_FL_CLIENTS * LM_FL_BATCH
    rows.append(check_flash(dev, "mla_tiny", n, 4, 4, 33, 96, "float32",
                            Dv=64))
    # whisper-medium serving: the encoder's bidirectional 16 heads of 64
    # over 1,500 frames, and the decoder's cross-attention, 224 prompt
    # tokens against the 1,500 frames (keys of their own length, no
    # mask); llava-next-mistral-7b serving: 32 heads on 8 of 128 over
    # 2,880 prefix + 2,048 text positions, window 4,096.
    rows.append(check_flash(dev, "whisper_encoder", B, 16, 16, AUDIO_FRAMES,
                            64, "bfloat16", causal=False))
    rows.append(check_flash(dev, "whisper_cross", B, 16, 16, AUDIO_PROMPT,
                            64, "bfloat16", causal=False, Sk=AUDIO_FRAMES))
    rows.append(check_flash(dev, "llava_serve", B, 32, 8, VLM_PREFIX + S,
                            128, "bfloat16", window=VLM_WINDOW))
    emit("lm_kernels", rows=rows)
    return rows


# ----------------------------------------------------------------- serve
SERVE_ARCH = "hymba-1.5b"


def phase_serve(dev, arch: str = SERVE_ARCH, name: str = "serve") -> dict:
    """A full-width LM (bf16, random weights from a seed; hymba-1.5b, or
    rwkv6-1.6b as `serve_rwkv`): a warm batch and a profiled one of
    `serve.serve_batch` (`_profiled_batch`), then `serve.main`
    (`_serve_main`), which draws its own weights as a user's run does."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    profiled = _profiled_batch(cfg, params, prompts)
    del params
    out = dict(_serve_main(dev, arch), init_s=init_s,
               profiled_batch=profiled)
    emit(name, **out)
    return out


def _layer_launches(cfg) -> dict[str, int]:
    """Launches of each LM kernel that one forward (and backward) of `cfg`
    makes: flash_attention (and its backward) per attention layer (attn,
    moe, hybrid; an enc-dec model's encoder layers, and its decoder's
    layers twice: self- and cross-attention), wkv6 (and its backward) per
    scan layer (rwkv, hybrid), and each SSD kernel per hybrid layer."""
    segs = cfg.resolved_segments
    attn = sum(s.n_layers for s in segs if s.kind in ("attn", "moe",
                                                      "hybrid"))
    if cfg.encoder is not None:
        attn = cfg.encoder.n_layers + 2 * attn
    scan = sum(s.n_layers for s in segs if s.kind in ("rwkv", "hybrid"))
    ssd = sum(s.n_layers for s in segs if s.kind == "hybrid")
    return {"flash_attention": attn, "flash_attention_bwd": attn,
            "wkv6": scan, "wkv6_bwd": scan,
            **{k: ssd for k in SSD_KERNELS}}


def _serve_main(dev, arch: str) -> dict:
    """`serve.main` at full width (traced, so the prefill span and every
    decode step end in a device sync; it draws its own weights, as a
    user's run does), with the launch counters zeroed just before and
    read just after: one launch of each forward kernel a layer a prefill
    batch, finite logits, tokens in range."""
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                 # the serve path's counts start here
    t0 = time.perf_counter()
    with obs.tracing():
        done, tokens, logits = serve.main([
            "--arch", arch, "--full-config", "--device", "cuda",
            "--requests", str(SERVE_REQUESTS), "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--max-new", str(SERVE_NEW)])
        summary = obs.metrics_summary()
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_batches = SERVE_REQUESTS // SERVE_BATCH
    want = {k: n * n_batches for k, n in _layer_launches(cfg).items()
            if k in ("flash_attention", "wkv6", "ssd_front", "ssd_back")}
    require(all(launches[k] == n for k, n in want.items()),
            f"serve {arch} launched {launches}; expected {want}")
    require(tokens.shape == (SERVE_REQUESTS, SERVE_NEW + 1)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"serve tokens out of range or misshapen: {tuple(tokens.shape)}")
    require(logits.shape == (SERVE_REQUESTS, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "serve logits not finite")
    spans, counters = summary["spans"], summary["counters"]
    require(counters.get("launch.requests_served") == SERVE_REQUESTS
            and counters.get("launch.decode_tokens")
            == SERVE_REQUESTS * SERVE_NEW, f"serve counters: {counters}")
    serving_s = spans["launch.serve_batch"]["total_s"]
    return dict(
        arch=arch, dtype=cfg.dtype, requests=SERVE_REQUESTS,
        batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
        launches=launches, record=done, main_wall_s=main_wall,
        serving_wall_s=serving_s,
        tokens_per_s=SERVE_REQUESTS * SERVE_NEW / serving_s,
        prefill_ms_per_batch=spans["launch.prefill"]["total_s"]
        / spans["launch.prefill"]["count"] * 1e3,
        decode_ms_per_batch=spans["launch.decode"]["total_s"]
        / spans["launch.decode"]["count"] * 1e3,
        decode_p50_ms=done["decode_p50_ms"],
        decode_p99_ms=done["decode_p99_ms"],
        peak_device_memory_bytes=peak)


def _profiled_batch(cfg, params, prompts, stub: dict | None = None) -> dict:
    """One warm serving batch (`_serve`) plain (wall), then the same batch
    under torch.profiler: device busy time, idle share, time by kernel."""
    run = lambda: _serve(cfg, params, prompts, SERVE_NEW, stub)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with _device_profile() as prof:
        run()
        torch.cuda.synchronize()
    return dict(wall_s=wall, **_device_time(prof, wall))


def _serve(cfg, params, prompts, max_new: int, stub: dict | None = None):
    """One arrival batch through the package's serving entry points:
    `serve.serve_batch` (an enc-dec model's frames as `enc=`), or, with
    prefix embeddings, `init_decode_cache(..., prompt=, prefix_embeds=)`
    and `make_serve_step` (`serve_batch` keeps the reference's signature,
    which has no prefix), timed the same way (a `launch.prefill` span and
    per-step latencies that end in a device sync when traced). Returns
    (tokens (B, max_new + 1), latencies (s), logits (max_new + 1, B, V))."""
    stub = stub or {}
    if "prefix_embeds" not in stub:
        return serve.serve_batch(cfg, params, prompts, max_new,
                                 enc=stub.get("enc_embeds"))
    prefix = stub["prefix_embeds"]
    B, max_seq = prompts.shape[0], prefix.shape[1] + prompts.shape[1] \
        + max_new + 8
    measure = obs.enabled()
    sync = torch.cuda.synchronize if prompts.is_cuda else (lambda: None)
    with torch.inference_mode():
        with obs.span("launch.prefill", batch=B):
            logits, cache = init_decode_cache(cfg, params, B, max_seq,
                                              prompt=prompts,
                                              prefix_embeds=prefix)
            if measure:
                sync()
        step = make_serve_step(cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out, all_logits, lat_s = [tok], [logits], []
        for _ in range(max_new):
            t0 = time.perf_counter()
            tok, logits, cache = step(params, tok, cache)
            if measure:
                sync()
                lat_s.append(time.perf_counter() - t0)
            out.append(tok)
            all_logits.append(logits)
    return torch.cat(out, dim=1), lat_s, torch.stack(all_logits)


def _stub_inputs(cfg, B: int, seed: int, device) -> dict:
    """Seeded random stub-modality inputs for cfg, in its dtype: frame
    embeddings (B, n_frames, d) for an enc-dec model, prefix embeddings
    (B, n_prefix_tokens, d) for a VLM, nothing for the others. Drawn on
    the CPU, so the card and the CPU get the same values."""
    g = torch.Generator().manual_seed(seed)
    draw = lambda n: torch.randn((B, n, cfg.d_model), generator=g).to(
        getattr(torch, cfg.dtype)).to(device)
    if cfg.encoder is not None:
        return {"enc_embeds": draw(cfg.encoder.n_frames)}
    if cfg.n_prefix_tokens:
        return {"prefix_embeds": draw(cfg.n_prefix_tokens)}
    return {}


def _serve_cut_depth(dev, cfg) -> dict:
    """A full-width model whose depth is cut (bf16, random weights from a
    seed): one batch of 4 x 2048 prompt tokens and 32 new tokens through
    `serve.serve_batch` (the launcher's batch function) after a warm one,
    traced, launch counters zeroed just before and read just after: one
    `flash_attention` launch a layer and no `wkv6`, tokens in range,
    finite logits; then the batch once more under torch.profiler."""
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = count_params(params)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    serve.serve_batch(cfg, params, prompts, SERVE_NEW)   # warm-up
    # The decode cache's bytes a token a layer, from the cache that
    # prefill builds (one sequence of one token, 8 slots).
    _, cache = init_decode_cache(cfg, params, 1, 8)
    cache_bytes = sum(t.nbytes for seg in cache["segments"]
                      for t in seg.values()) / (8 * cfg.n_layers)
    del cache
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with obs.tracing():
        tokens, lat_s, logits = serve.serve_batch(cfg, params, prompts,
                                                  SERVE_NEW)
        summary = obs.metrics_summary()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(launches["flash_attention"] == cfg.n_layers
            and launches["wkv6"] == 0,
            f"{cfg.name}: launched {launches}; expected {cfg.n_layers} "
            "flash_attention")
    require(tokens.shape == (SERVE_BATCH, SERVE_NEW + 1)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{cfg.name}: tokens out of range: {tuple(tokens.shape)}")
    require(bool(torch.isfinite(logits).all()),
            f"{cfg.name}: logits not finite")
    spans = summary["spans"]
    profiled = _profiled_batch(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    return dict(
        n_layers=cfg.n_layers, params=n_params, dtype=cfg.dtype,
        batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
        launches=launches, wall_s=wall,
        tokens_per_s=SERVE_BATCH * SERVE_NEW / wall,
        prefill_ms=spans["launch.prefill"]["total_s"] * 1e3,
        decode_ms=spans["launch.decode"]["total_s"] * 1e3,
        decode_p50_ms=serve._quantile_ms(lat_s, 0.50),
        decode_p99_ms=serve._quantile_ms(lat_s, 0.99),
        peak_device_memory_bytes=peak, setup_s=setup_s,
        decode_cache_bytes_per_token_layer=cache_bytes,
        profiled_batch=profiled)


def phase_serve_moe(dev) -> dict:
    """grok-1 at full width (d 6144, 48 heads of 128 on 8 KV heads, 8
    experts of d_ff 32,768 top-2 at capacity factor 1.5, softcap 30,
    vocab 131,072) with only the depth cut, to MOE_LAYERS of 64 (8.2 B
    params, 16.5 GB: the whole model does not fit one card), served as
    `_serve_cut_depth` says."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    out = dict(arch=MOE_ARCH, **_serve_cut_depth(dev, cfg))
    emit("serve_moe", **out)
    return out


def phase_serve_mla(dev) -> dict:
    """deepseek-v3 at full width (d 7168, 128 MLA heads: queries and keys
    of 192 dims, values of 128, q / kv latents of 1536 / 512; vocab
    129,280, untied head and the MTP head) with only the depth cut, to
    one dense layer (d_ff 18,432) and one MoE layer (256 experts of d_ff
    2,048, top-8, 1 shared, capacity factor 1.5): 14,870,813,696 params,
    29.7 GB, as the reference's `eval_shape` counts them (the whole 671 B
    model does not fit one card). Served as `_serve_cut_depth` says: 2
    `flash_attention` launches at (D, Dv) = (192, 128) a prefill batch,
    decode in the absorbed form against the (c_kv, k_rope) cache, whose
    bytes a token a layer are set beside an expanded 128-head k/v
    cache's."""
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=2, segments=(
        Segment("attn", 1), Segment("moe", 1)))
    out = dict(arch=MLA_ARCH, **_serve_cut_depth(dev, cfg))
    require(out["params"] == 14_870_813_696,
            f"serve_mla: {out['params']} params; the reference counts "
            "14,870,813,696")
    # The latent cache (c_kv of 512 and k_rope of 64 a token a layer)
    # against per-head k (192) and v (128) of every head, both bf16.
    mla, size = cfg.mla, torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    expanded = cfg.n_heads * (mla.nope_head_dim + mla.rope_head_dim
                              + mla.v_head_dim) * size
    require(out["decode_cache_bytes_per_token_layer"]
            == (mla.kv_lora_rank + mla.rope_head_dim) * size,
            f"serve_mla: the decode cache holds "
            f"{out['decode_cache_bytes_per_token_layer']} bytes a token a "
            "layer, not the latent's")
    out.update(expanded_kv_bytes_per_token_layer=expanded)
    emit("serve_mla", **out)
    return out


def _serve_full(dev, cfg, prompt_len: int, name: str) -> dict:
    """A full-width model with a stubbed modality (bf16; random weights,
    prompts and stub inputs from seeds): SERVE_REQUESTS requests of
    `prompt_len` tokens in batches of SERVE_BATCH, each with its own
    frames or prefix embeddings, SERVE_NEW new tokens, through `_serve`
    after a warm batch, traced, with the launch counters zeroed just
    before and read just after: per prefill batch the `flash_attention`
    launches `_layer_launches` counts and no `wkv6`, tokens in range,
    finite logits. The trace is written with `obs.write_chrome_trace`
    and read back. Then one batch under torch.profiler, and the decode
    cache's slots and bytes a request."""
    n_batches = SERVE_REQUESTS // SERVE_BATCH
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = count_params(params)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, prompt_len),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    stubs = [_stub_inputs(cfg, SERVE_BATCH, 2 + i, dev)
             for i in range(n_batches)]
    _serve(cfg, params, prompts[:SERVE_BATCH], SERVE_NEW, stubs[0])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                 # this path's counts start here
    t0 = time.perf_counter()
    tokens, lat_all = [], []
    trace_path = os.path.join(ROOT, "build", f"{name}_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    with obs.tracing():
        for i in range(n_batches):
            with obs.span("launch.serve_batch", batch=SERVE_BATCH):
                toks, lat_s, logits = _serve(
                    cfg, params, prompts[i * SERVE_BATCH:(i + 1) * SERVE_BATCH],
                    SERVE_NEW, stubs[i])
            tokens.append(toks)
            lat_all += lat_s
            require(bool(torch.isfinite(logits).all()),
                    f"{name}: logits not finite")
        summary = obs.metrics_summary()
        obs.write_chrome_trace(trace_path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with open(trace_path) as f:
        trace = json.load(f)
    n_spans = sum(ev["ph"] == "X" for ev in trace["traceEvents"])
    per_prefill = _layer_launches(cfg)["flash_attention"]
    require(launches["flash_attention"] == per_prefill * n_batches
            and launches["wkv6"] == 0,
            f"{name}: launched {launches}; expected {per_prefill} "
            "flash_attention a prefill batch")
    tokens = torch.cat(tokens)
    require(tokens.shape == (SERVE_REQUESTS, SERVE_NEW + 1)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{name}: tokens out of range: {tuple(tokens.shape)}")
    spans = summary["spans"]
    require(spans["launch.prefill"]["count"] == n_batches
            and n_spans == sum(v["count"] for v in spans.values()),
            f"{name}: the trace's {n_spans} spans do not match the tracer's "
            f"{spans}")
    profiled = _profiled_batch(cfg, params, prompts[:SERVE_BATCH], stubs[0])
    # The decode cache of one request: self-attention slots (the window
    # where it is shorter than the sequence), and an enc-dec model's
    # cross K/V over its frames.
    max_seq = (cfg.n_prefix_tokens + prompt_len + SERVE_NEW + 8)
    _, cache = init_decode_cache(cfg, params, 1, max_seq, **{
        k: v[:1] for k, v in stubs[0].items() if k == "enc_embeds"})
    cache_slots = cache["segments"][0]["k"].shape[2]
    cache_bytes = sum(t.nbytes for seg in cache["segments"]
                      for t in seg.values())
    del params, cache
    torch.cuda.empty_cache()
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
        dtype=cfg.dtype, requests=SERVE_REQUESTS, batch=SERVE_BATCH,
        prompt_len=prompt_len, prefix_len=cfg.n_prefix_tokens,
        frames=cfg.encoder.n_frames if cfg.encoder is not None else 0,
        max_new=SERVE_NEW, launches=launches,
        flash_launches_per_prefill=launches["flash_attention"] // n_batches,
        wall_s=wall, tokens_per_s=SERVE_REQUESTS * SERVE_NEW / wall,
        prefill_ms_per_batch=spans["launch.prefill"]["total_s"]
        / n_batches * 1e3,
        decode_ms_per_batch=(spans["launch.serve_batch"]["total_s"]
                             - spans["launch.prefill"]["total_s"])
        / n_batches * 1e3,
        decode_p50_ms=serve._quantile_ms(lat_all, 0.50),
        decode_p99_ms=serve._quantile_ms(lat_all, 0.99),
        peak_device_memory_bytes=peak, setup_s=setup_s,
        decode_cache_slots=cache_slots,
        decode_cache_bytes_per_request=cache_bytes,
        trace_file=os.path.relpath(trace_path, ROOT), trace_spans=n_spans,
        profiled_batch=profiled)


def phase_serve_audio(dev) -> dict:
    """whisper-medium at full width (24 encoder + 24 decoder layers, d
    1024, 16 heads of 64, vocab 51,865, sinusoidal positions, tied
    embeddings; 757,877,760 params, the reference's `eval_shape` count):
    8 requests of 1,500 random frames (30 s of audio) and a 224-token
    prompt, 32 new tokens, served as `_serve_full` says: the encoder once
    a batch, prefill caching each decoder layer's cross K/V, 72
    `flash_attention` launches a prefill (24 encoder, 24 self, 24 cross
    at 224 queries against 1,500 keys)."""
    out = _serve_full(dev, get_config(AUDIO_ARCH), AUDIO_PROMPT,
                      "serve_audio")
    require(out["params"] == 757_877_760,
            f"serve_audio: {out['params']} params; the reference counts "
            "757,877,760")
    emit("serve_audio", **out)
    return out


def phase_serve_vlm(dev) -> dict:
    """llava-next-mistral-7b at full width (32 layers, d 4096, 32 heads on
    8 KV heads of 128, d_ff 14,336, window 4,096, vocab 32,000;
    7,241,732,096 params, 14.5 GB in bf16): 8 requests of 2,880 random
    prefix embeddings (the stubbed vision tower) and 2,048 text tokens,
    32 new tokens, served as `_serve_full` says: the 4,928-position
    prefill passes the window, so each layer's 4,096-slot cache keeps
    the last 4,096 positions ring-aligned; 32 `flash_attention` launches
    a prefill."""
    out = _serve_full(dev, get_config(VLM_ARCH), SERVE_PROMPT, "serve_vlm")
    require(out["params"] == 7_241_732_096 and out["decode_cache_slots"]
            == VLM_WINDOW, f"serve_vlm: {out['params']} params, "
            f"{out['decode_cache_slots']} cache slots; expected "
            f"7,241,732,096 and {VLM_WINDOW}")
    emit("serve_vlm", **out)
    return out


def _reduced_cfgs() -> dict:
    """The reduced configs (f32) that the card is held to the CPU on:
    hymba-1.5b, gemma-2b, rwkv6-1.6b, grok-1, whisper-medium (64 frames),
    llava-next-mistral-7b (16 prefix embeddings) and deepseek-v3 (cut as
    lm_moe_tiny: MLA, a MoE layer, the MTP head)."""
    cfgs = {arch: get_config(arch).reduced()
            for arch in (SERVE_ARCH, "gemma-2b", RWKV_ARCH, MOE_ARCH,
                         AUDIO_ARCH, VLM_ARCH)}
    cfgs[MLA_ARCH] = get_config(MLA_ARCH).reduced(**MLA_TINY)
    return cfgs


def phase_serve_cpu_vs_card(dev) -> dict:
    """Reduced hymba-1.5b, gemma-2b, rwkv6-1.6b, grok-1, whisper-medium,
    llava-next-mistral-7b and deepseek-v3 (f32) from the same weights
    through `_serve` on the CPU and the card: prefill of a 160-token
    prompt (the reduced 128-token window rolls; grok-1's and
    deepseek-v3's routed experts dispatch row-locally; whisper's 64 and
    llava's 16 seeded random frame and prefix embeddings), then 8 greedy
    decode steps (grok-1's: one global dispatch; deepseek-v3's MLA in the
    absorbed form; whisper's against the cached cross K/V)."""
    out = {}
    for arch, cfg in _reduced_cfgs().items():
        cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
        prompts = torch.randint(0, cfg.vocab_size, (2, 160),
                                generator=torch.Generator().manual_seed(1))
        runs = {}
        for where, params in (("cpu", cpu_params), ("card", card_params)):
            at = params["embed"].device
            toks, _, logits = _serve(cfg, params, prompts.to(at), 8,
                                     _stub_inputs(cfg, 2, 2, at))
            runs[where] = (toks.cpu(), logits.cpu())
        same = bool(torch.equal(runs["card"][0], runs["cpu"][0]))
        gap = float((runs["card"][1] - runs["cpu"][1]).abs().max())
        out[arch] = dict(tokens_identical=same, logits_max_abs_gap=gap,
                         tol=1e-4)
        require(same, f"{arch}: greedy tokens differ between card and CPU")
        require(gap <= 1e-4, f"{arch}: logits differ by {gap} > 1e-4")
    emit("serve_cpu_vs_card", **out)
    return out


# ------------------------------------------------------------ LM training
# The backward kernels against their plain backward (`ref.*_bwd_ref`, the
# kernels' own formulas in torch), on the same inputs: f32 rtol = atol =
# 2e-5; bf16 as the forward (FLASH_TOL): both sides widen the same bf16
# inputs to f32 and round one f32 result, so they differ by at most one
# bf16 step, 2**-7 * |want| < 8e-3 * |want| (atol 1e-3 for results near
# 0). One written exception: wkv6's dlogw is a
# suffix sum over the whole sequence of q_t - p_t (q = r dr, p = k dk),
# terms that cancel, so its rounding scales with those terms and not with
# the result; its atol is 2e-5 of max |r dr| + max |k dk| (at full width
# on an H100 the gap measured 4.7e-4 against terms of 614, 7.6e-7 of
# them; PERF.md).
BWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-3)}
TRAIN_ARCH = "hymba-1.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# The launcher's default lr (--lr), as the reference's launcher.
TRAIN_LR = 1e-3
# The fixed-batch steps must lower the loss by more than this many times
# the spread of the initial weights' loss over TRAIN_STEPS other batches
# (how far the loss moves with the batch alone).
TRAIN_DROP_SPREADS = 3.0
# The constellation's LM cell: c2s2/g1 (4 clients a round, 32 sequences
# of 33 tokens each): 128 sequences a kernel launch.
LM_FL_CLIENTS, LM_FL_BATCH, LM_FL_ROUNDS = 4, 32, 3
LM_FL_HORIZON_S = 2 * 86400.0


def _flash_bwd_inputs(dev, B, H, KV, S, D, Dv, dtype, Sk):
    g = torch.Generator(device=dev).manual_seed(B * H * S + D + 1 + Sk - S)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, S, D), generator=g, device=dev).to(dt)
    do = torch.randn((B, H, S, Dv), generator=g, device=dev).to(dt)
    k = torch.randn((B, KV, Sk, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, KV, Sk, Dv), generator=g, device=dev).to(dt)
    return q, k, v, do


def check_flash_bwd(dev, case: str, B: int, H: int, KV: int, S: int, D: int,
                    dtype: str, causal: bool = True,
                    window: int | None = None, Dv: int | None = None,
                    Sk: int | None = None) -> dict:
    """flash_attention_bwd against its plain backward, both given the
    plain forward's lse, values of head dim Dv (D unless given), keys of
    length Sk (S unless given); the yardstick is the backward of
    scaled_dot_product_attention (`_sdpa_call`), its forward run once
    outside the timing."""
    Dv, Sk = Dv or D, Sk or S
    q, k, v, do = _flash_bwd_inputs(dev, B, H, KV, S, D, Dv, dtype, Sk)
    kw = dict(causal=causal, window=window)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    again = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    err = max(_max_err(a, w, *BWD_TOL[dtype]) for a, w in zip(got, want))
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"flash_attention_bwd {case}: two launches differ")
    pairs = B * H * _flash_pairs(S, causal, window, Sk)
    # q, k, dq, dk of D columns; v, o, dO, dv of Dv; lse.
    n_bytes = (2 * (B * H * S + B * KV * Sk) * (D + Dv) * q.element_size()
               + B * H * S * 4)
    # Q K^T, dS K, dS^T Q over D; dO V^T, P^T dO over Dv.
    b_ms, b_by = bound_ms(n_bytes, 2 * (3 * D + 2 * Dv) * pairs,
                          BF16_FLOPS_PER_S if dtype == "bfloat16"
                          else F32_FLOPS_PER_S)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_fwd, backend, note = _sdpa_call(*leaves, causal, window)
    lib_o = lib_fwd()
    lib_do = torch.nn.functional.pad(do, (0, lib_o.shape[-1] - Dv))
    library = lambda: torch.autograd.grad(lib_o, leaves, lib_do,
                                          retain_graph=True)
    return dict(
        name="flash_attention_bwd", case=case, B=B, H=H, KV=KV, S=S, Sk=Sk,
        D=D, Dv=Dv, dtype=dtype, causal=causal, window=window, pairs=pairs,
        max_abs_err=err, rtol=BWD_TOL[dtype][0], atol=BWD_TOL[dtype][1],
        deterministic=True, library_backend=backend, library_note=note,
        ms=device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw)),
        plain_ms=device_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, do, lse=lse, **kw)),
        library_ms=device_ms(library), bound_ms=b_ms, bound_by=b_by)


def _wkv6_bwd_errs(r, k, got, want) -> tuple[list[float], float]:
    """Each output's max error within BWD_TOL; dlogw's atol scales with
    its terms, max |r dr| + max |k dk|."""
    rtol, atol = BWD_TOL["float32"]
    terms = float((r * want[0]).abs().max() + (k * want[1]).abs().max())
    return [_max_err(a, w, rtol, atol * terms if i == 3 else atol)
            for i, (a, w) in enumerate(zip(got, want))], terms


def _wkv6_grads_f64(r, k, v, lw, s0, do) -> tuple:
    """The scan's (dr, dk, dv, dlogw) in float64: autograd of its
    step-by-step recurrence S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,
    o_t = r_t S_{t-1} (no chunking, no f32 rounding)."""
    leaves = [t.double().requires_grad_(True) for t in (r, k, v, lw)]
    R, Kk, V, W = leaves
    S = s0.double()
    outs = []
    for t in range(R.shape[2]):
        outs.append(torch.einsum("bhk,bhkv->bhv", R[:, :, t], S))
        S = torch.exp(W[:, :, t])[..., None] * S \
            + Kk[:, :, t, :, None] * V[:, :, t, None, :]
    o = torch.stack(outs, 2)
    return torch.autograd.grad((o * do.double()).sum(), leaves)


# With rwkv6's decays (w0's span: -exp(-6 .. -1) a step) the scan keeps
# hundreds of steps, and f32 sums of that many terms of |r||k||v| ~ 10
# miss the exact gradient by up to ~1e-4 in either summation order (the
# plain f32 backward by 0.8-1.0 of 2e-5 + 2e-5 |g| at one batch of 4
# heads on the CPU, where the kernel's chunked order landed 9.2e-5 from
# the plain version on the card). So the time mix's rows hold the
# kernel to the float64 gradient within F64_SLACK times the plain f32
# version's own distance from it (or from 2e-5, if that is larger), per
# output.
F64_SLACK = 2.0


def check_wkv6_bwd(dev, case: str, B: int, H: int, T: int, K: int,
                   V: int, ssd_views: bool = True,
                   rwkv_views: bool = False) -> dict:
    """wkv6_bwd against its plain backward, both given the plain
    forward's chunk states (which the kernel's forward must match within
    WKV6_TOL); with `ssd_views` the inputs are in the SSD
    heads' layout (k broadcast over heads, logw over the state dim, v a
    transposed view), as the training path passes them; with `rwkv_views`
    as the RWKV6 time mix passes them (`_rwkv_inputs`); else dense with a
    decay per state dim."""
    g = torch.Generator(device=dev).manual_seed(B * H * T + K + 1)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    r = rnd(B, H, T, K)
    if rwkv_views:
        r, k, v, lw = _rwkv_inputs(dev, B, H, T, K, g)
    elif ssd_views:
        k = rnd(B, 1, T, K).expand(B, H, T, K)
        v = rnd(B, T, H, V).transpose(1, 2)
        lw = -0.3 * rnd(B, H, T, 1).abs().expand(B, H, T, K)
    else:
        k, v = rnd(B, H, T, K), rnd(B, H, T, V)
        lw = -0.3 * rnd(B, H, T, K).abs()
    s0 = torch.zeros((B, H, K, V), device=dev)
    do = rnd(B, H, T, V)
    states = ref.wkv6_ref(r, k, v, lw, s0, return_states=True)[2]
    states_err = _max_err(wkv6(r, k, v, lw, s0, return_states=True)[2],
                          states, WKV6_TOL)
    args = (r, k, v, lw, s0, do, None, states)
    got = wkv6_bwd(*args)
    want = ref.wkv6_bwd_ref(*args[:7], 64, states)
    again = wkv6_bwd(*args)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"wkv6_bwd {case}: two launches differ")
    if rwkv_views:
        exact = _wkv6_grads_f64(r, k, v, lw, s0, do)
        gap = lambda a, e: float((a.double() - e).abs().max())
        f64_errs = [(gap(a, e), gap(w, e))
                    for a, w, e in zip(got[:4], want[:4], exact)]
        require(all(ka <= F64_SLACK * max(pa, BWD_TOL["float32"][1])
                    for ka, pa in f64_errs),
                f"wkv6_bwd {case}: kernel vs float64 {f64_errs} (kernel, "
                f"plain f32) past {F64_SLACK}x the plain version's")
        terms = float((r * want[0]).abs().max() + (k * want[1]).abs().max())
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        del exact
    else:
        f64_errs = None
        errs, terms = _wkv6_bwd_errs(r, k, got, want)
    # Each input of the gradient read once (a broadcast input's distinct
    # elements), each output (dense dr, dk, dv, dlogw, ds0) written once;
    # the forward's chunk states are not counted, since the gradient can
    # recompute them from r, k, v and logw (`states_bytes`, the kernel's
    # choice to read them instead). Operations: the step-by-step
    # recurrences, forward state (3 K V) and backward (dS 3, dr 2, dk 2,
    # dv 2, dlogw 2 K V).
    n_in = sum(x.untyped_storage().nbytes() for x in args[:7]
               if x is not None)
    n_out = (3 * B * H * T * K + B * H * T * V + B * H * K * V) * 4
    b_ms, b_by = bound_ms(n_in + n_out, 14 * B * H * T * K * V)
    return dict(
        name="wkv6_bwd", case=case, B=B, H=H, T=T, K=K, V=V, chunk=64,
        ssd_views=ssd_views and not rwkv_views, rwkv_views=rwkv_views,
        max_abs_err=max(errs),
        dlogw_max_abs_err=errs[3], dlogw_terms=terms,
        f64_max_abs_err=f64_errs, f64_slack=F64_SLACK if rwkv_views
        else None,
        tol=BWD_TOL["float32"][0], deterministic=True,
        states_max_abs_err=states_err,
        states_bytes=states.untyped_storage().nbytes(),
        ms=device_ms(lambda: wkv6_bwd(*args)),
        plain_ms=device_ms(lambda: ref.wkv6_bwd_ref(*args[:7], 64, states)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_lm_train_kernels(dev) -> list[dict]:
    """Both backward kernels at the training paths' shapes (the LM cell's
    128 sequences of 33 tokens; full-width hymba-1.5b, rwkv6-1.6b and
    deepseek-v3 at 2 x 2048; whisper-medium), the D = 32 forward
    (lm_tiny), and the SSD heads' kernels (`check_ssd`) against their
    plain versions."""
    n = LM_FL_CLIENTS * LM_FL_BATCH
    rows = [
        check_flash(dev, "lm_tiny_d32", n, 2, 2, 33, 32, "float32"),
        check_flash_bwd(dev, "lm_tiny", n, 2, 2, 33, 32, "float32"),
        check_flash_bwd(dev, "lm_hybrid_tiny", n, 4, 4, 33, 64, "float32",
                        window=128),
        check_flash_bwd(dev, "train_swa", TRAIN_BATCH, 25, 5, TRAIN_SEQ, 64,
                        "bfloat16", window=1024),
        check_flash_bwd(dev, "train_full", TRAIN_BATCH, 25, 5, TRAIN_SEQ, 64,
                        "bfloat16"),
        # The bf16 kernels' other head dims at their configs' heads: 128
        # (qwen, yi: 32 heads on 8, windowed here) and 256 (gemma-2b: 8
        # heads on 1).
        check_flash_bwd(dev, "d128", 1, 32, 8, TRAIN_SEQ // 2, 128,
                        "bfloat16", window=512),
        check_flash_bwd(dev, "gemma_d256", 1, 8, 1, TRAIN_SEQ, 256,
                        "bfloat16"),
        check_wkv6_bwd(dev, "lm_hybrid_tiny", n, 8, 33, 16, 64),
        check_wkv6_bwd(dev, "train", TRAIN_BATCH, 50, TRAIN_SEQ, 16, 64),
        # rwkv6-1.6b's time-mix: 32 heads of K = V = 64 at chunk 64,
        # dense, and as lm_train's rwkv6 step and lm_rwkv6_tiny pass them.
        check_wkv6_bwd(dev, "rwkv6_k64", 1, 32, TRAIN_SEQ, 64, 64,
                       ssd_views=False),
        check_wkv6_bwd(dev, "rwkv6_train", TRAIN_BATCH, 32, TRAIN_SEQ, 64,
                       64, rwkv_views=True),
        check_wkv6_bwd(dev, "lm_rwkv6_tiny", n, 4, 33, 64, 64,
                       rwkv_views=True),
        # MLA's f32 backward: lm_moe_tiny's step at (96, 64), and
        # deepseek-v3's heads (192, 128) at a short length.
        check_flash_bwd(dev, "mla_tiny", n, 4, 4, 33, 96, "float32", Dv=64),
        check_flash_bwd(dev, "mla_d192", 1, 4, 4, 256, MLA_D, "float32",
                        Dv=MLA_DV),
        # deepseek-v3's bf16 training step (lm_train_mla): 128 heads of
        # (192, 128) at 2 x 2048, causal.
        check_flash_bwd(dev, "mla_train", TRAIN_BATCH, 128, 128, TRAIN_SEQ,
                        MLA_D, "bfloat16", Dv=MLA_DV),
        # whisper-medium training (batch 4 x 448 text tokens, 1,500
        # frames): the encoder's backward and the cross-attention's.
        check_flash_bwd(dev, "whisper_encoder", AUDIO_TRAIN_BATCH, 16, 16,
                        AUDIO_FRAMES, 64, "bfloat16", causal=False),
        check_flash_bwd(dev, "whisper_cross", AUDIO_TRAIN_BATCH, 16, 16,
                        AUDIO_TRAIN_SEQ, 64, "bfloat16", causal=False,
                        Sk=AUDIO_FRAMES)]
    # The SSD heads' kernels at the benchmark cell's step (hymba-1.5b,
    # bf16, 4 x 2048), a ragged f32 length, lm_hybrid_tiny's width as
    # lm_fl stacks its clients (G = LM_FL_CLIENTS), and a stack of three
    # clients with a conv tail.
    rows += check_ssd(dev, "train", SSD_CELL_BATCH, TRAIN_SEQ, "bfloat16")
    rows += check_ssd(dev, "ragged_f32", 1, 200, "float32")
    rows += check_ssd(dev, "lm_hybrid_tiny", LM_FL_BATCH, 33, "float32",
                      E=512, G=LM_FL_CLIENTS)
    rows += check_ssd(dev, "stack_tail", 2, 200, "bfloat16", G=3, tail=True)
    emit("lm_train_kernels", rows=rows)
    return rows


# ------------------------------------------------------- the SSD heads
SSD_FORWARD = ("ssd_front", "ssd_back")
SSD_KERNELS = SSD_FORWARD + ("ssd_back_bwd", "ssd_front_bwd", "ssd_reduce")
# Kernel vs plain version (`tests/test_torch_cuda.py`'s SSD_TOL): 1e-4 of
# each output's scale in f32, 2e-2 in bf16 (one rounding step of a
# model-dtype value).
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_CELL_BATCH = 4           # the benchmark cell's rows a local step


def _ssd_inputs(dev, B: int, T: int, dtype, E: int, seed: int, G: int = 1,
                tail: bool = False):
    """The SSD heads' inputs at the model's scale, seeded, for G clients:
    xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, d_skip, out_norm and
    the conv tail (None unless `tail`)."""
    H = E // 64
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    a_log = torch.log(torch.linspace(1.0, 8.0, H, device=dev))[None]
    out = (rnd(G, B * T, 2 * E), 0.5 * rnd(G, B * T, H),
           0.3 * rnd(G, B * T, 16), 0.3 * rnd(G, B * T, 16),
           0.1 * rnd(G, 4, E), 0.1 * rnd(G, E), -2.0 + 0.1 * rnd(G, H),
           a_log + 0.1 * rnd(G, H), 1.0 + 0.1 * rnd(G, H), 0.1 * rnd(G, E),
           rnd(G, B, 3, E) if tail else None)
    return tuple(None if t is None else t.to(dtype).contiguous()
                 for t in out)


def _ssd_composition(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log,
                     d_skip, out_norm, T: int):
    """The plain PyTorch composition that the SSD kernels replace (the
    port's `ssm_stacked` before them), as two functions: front(xz, ...) ->
    the scan's inputs (r, k, v, logw, as views), back(o, v, xh) -> y."""
    from repro_torch.models.lm.layers import rmsnorm
    G, n, E2 = xz.shape
    E, B, H = E2 // 2, n // T, E2 // 2 // 64
    state = {}

    def front(xz, dt_raw, bt, ct):
        xs, z = xz.chunk(2, dim=-1)
        x = xs.reshape(G, B, T, E)
        xp = torch.cat([x.new_zeros((G, B, 3, E)), x], dim=-2)
        w, b = conv_w[:, None, None], conv_b[:, None, None]
        y = sum(xp[..., i:i + T, :] * w[..., i, :] for i in range(4)) + b
        xh = torch.nn.functional.silu(y).reshape(G * B, T, H, 64)
        u = (dt_raw + dt_b[:, None]).float()
        dt = torch.logaddexp(u, torch.zeros((), device=u.device))
        logw = (-dt * torch.exp(a_log[:, None])).reshape(G * B, T, H)
        b32, c32 = (t.float().reshape(G * B, T, -1) for t in (bt, ct))
        r = c32[:, None] * torch.exp(logw).transpose(1, 2)[..., None]
        k = b32[:, None].expand(G * B, H, T, 16)
        v = (xh.float() * dt.reshape(G * B, T, H)[..., None]).transpose(1, 2)
        lw = logw.transpose(1, 2)[..., None].expand(G * B, H, T, 16)
        state.update(xh=xh, z=z, b32=b32, c32=c32)
        return r, k, v, lw

    def back(o, v, xh, z, b32, c32):
        o = o.transpose(1, 2) + torch.einsum("btn,btn->bt", c32, b32)[
            ..., None, None] * v.transpose(1, 2)
        o = o.view(G, B, T, H, 64) + d_skip[:, None, None, :, None] \
            * xh.float().view(G, B, T, H, 64)
        y = o.reshape(G, n, E).to(xz.dtype)
        return rmsnorm(y * torch.nn.functional.silu(z), out_norm[:, None])

    return front, back, state


def _ssd_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _ssd_chain(dev, g: torch.Generator, xz, dt_raw, bt, ct, conv_w, conv_b,
               dt_b, a_log, d_skip, out_norm, tail, T: int):
    """The five SSD kernels against their plain versions on one set of
    inputs, each kernel fed the plain chain's values (the scan's output
    and its gradients drawn from `g`), the backward launched twice for
    the same bits -> ({kernel: the largest error against SSD_TOL, as a
    share of each output's scale}, the launches' arguments and outputs by
    name). `ssd_front_bwd`'s outputs are dxs, ddt_raw and the tail's
    gradient; those of `ssd_reduce`, which it launches, the weights',
    B's and C's gradients."""
    G, n, E2 = xz.shape
    E, B, H = E2 // 2, n // T, E2 // 2 // 64
    tol = SSD_TOL[str(xz.dtype).removeprefix("torch.")]

    def err(got, want) -> float:
        scale = max(1e-6, float(want.float().abs().max()))
        return _max_err(got, want, tol, tol * scale) / scale

    front_in = (xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, tail, T, 64)
    f_want = ref.ssd_front_ref(*front_in)
    f_got = ssd.ssd_front(*front_in)
    xh, r, v, k, dt, logw = f_want
    o = torch.randn((G * B, T, H, 64), generator=g, device=dev)
    back_in = (o, xh, xz, bt, ct, dt, d_skip, out_norm)
    b_want = ref.ssd_back_ref(*back_in, 64)
    b_got = ssd.ssd_back(*back_in, 64)
    dy = torch.randn((G, n, E), generator=g, device=dev).to(xz.dtype)
    rstd = b_want[1]
    du, dz, p2, dnorm = ref.ssd_back_bwd_ref(dy, *back_in, rstd, 64)
    dxz = torch.empty(xz.shape, dtype=xz.dtype, device=dev)
    bb_got = ssd.ssd_back_bwd(dy, *back_in, rstd, 64, dxz)
    dv, dr, dk, dlw = (torch.randn(s, generator=g, device=dev) for s in
                       ((G * B, H, T, 64), (G * B, H, T, 16),
                        (G * B, H, T, 16), (G * B, H, T, 16)))
    fb_in = (du, dv, dr, dk, dlw, p2, xz, dt_raw, bt, ct, conv_w, conv_b,
             dt_b, a_log, d_skip, tail, dt, logw)
    fb_want = ref.ssd_front_bwd_ref(*fb_in, T, 64)
    fb_got = ssd.ssd_front_bwd(*fb_in, T, 64, dxz, bb_got[2])
    again = torch.empty_like(dxz)
    ssd.ssd_back_bwd(dy, *back_in, rstd, 64, again)
    again_grads = ssd.ssd_front_bwd(*fb_in, T, 64, again, bb_got[2])
    torch.cuda.synchronize()
    require(torch.equal(again, dxz) and all(
        a is None or torch.equal(a, b) for a, b in zip(fb_got, again_grads)),
        f"ssd G={G} B={B} T={T} E={E}: two launches differ")
    require((fb_got[9] is None) == (tail is None),
            "ssd_front_bwd: the tail's gradient does not follow the tail")
    errs = {
        "ssd_front": max(err(a, w) for a, w in zip(f_got, f_want)),
        "ssd_back": max(err(a, w) for a, w in zip(b_got, b_want)),
        "ssd_back_bwd": max(err(bb_got[0], du), err(bb_got[1], p2),
                            err(dxz[..., E:], dz)),
        "ssd_front_bwd": max([err(dxz[..., :E], fb_want[0]),
                              err(fb_got[0], fb_want[1])]
                             + ([] if tail is None
                                else [err(fb_got[9], fb_want[9])])),
        "ssd_reduce": max([err(a, w) for a, w in
                           zip(fb_got[1:8], fb_want[2:9])]
                          + [err(fb_got[8], dnorm.to(xz.dtype))])}
    io = dict(front_in=front_in, f_want=f_want, back_in=back_in,
              b_want=b_want, dy=dy, rstd=rstd, du=du, p2=p2, dv=dv, dr=dr,
              dk=dk, dlw=dlw, fb_in=fb_in, dxz=dxz, norm_part=bb_got[2],
              fb_got=fb_got)
    return errs, io


def _kernel_ms(fn, *names: str) -> dict[str, float]:
    """Median device time of each named kernel over TIMED_LAUNCHES calls
    of `fn`, by kernel name in a device profile: for a call that
    launches more than one kernel. The profiler may miss some launches
    (late in a process that has profiled before): the median is over
    those it kept, at least half of them for every name."""
    from torch.autograd import DeviceType

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with _device_profile() as prof:
        for _ in range(TIMED_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    times: dict[str, list] = {name: [] for name in names}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            for name in names:
                if name in e.name():
                    times[name].append((e.end_ns() - e.start_ns()) / 1e6)
    require(all(2 * len(t) >= TIMED_LAUNCHES for t in times.values()),
            f"profile of {names}: launches {[len(t) for t in times.values()]}"
            f" of {TIMED_LAUNCHES}")
    return {name: statistics.median(t) for name, t in times.items()}


def check_ssd(dev, case: str, B: int, T: int, dtype: str,
              E: int = 3200, G: int = 1, tail: bool = False) -> list[dict]:
    """The five SSD kernels against their plain versions (`_ssd_chain`)
    for G clients, with or without a conv tail, one row each: the largest
    error, device ms a launch (CUDA events; `ssd_front_bwd` and
    `ssd_reduce`, one call, split by kernel name in a device profile,
    with the call's own time as `call_ms`), the bound by bytes (each
    input and output once, the per-tile partials of the weights'
    gradients too), `plain_ms` of the plain version and
    `composition_ms` of the PyTorch composition it replaces (forward: its
    ops; backward: autograd of them; with a zero tail), both timed on the
    same inputs; the plain version and the composition of the two
    backward kernels of the front are one, on `ssd_front_bwd`'s row."""
    dt_ = getattr(torch, dtype)
    H = E // 64
    ins = _ssd_inputs(dev, B, T, dt_, E, seed=G * B * T + E, G=G, tail=tail)
    (xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, d_skip, out_norm,
     conv_tail) = ins
    g = torch.Generator(device=dev).manual_seed(T)
    errs, io = _ssd_chain(dev, g, *ins, T)
    front_in, back_in, fb_in = io["front_in"], io["back_in"], io["fb_in"]
    dy, rstd, dxz, part = io["dy"], io["rstd"], io["dxz"], io["norm_part"]
    run = {
        "ssd_front": lambda: ssd.ssd_front(*front_in),
        "ssd_back": lambda: ssd.ssd_back(*back_in, 64),
        "ssd_back_bwd": lambda: ssd.ssd_back_bwd(dy, *back_in, rstd, 64,
                                                 dxz),
        "ssd_front_bwd": lambda: ssd.ssd_front_bwd(*fb_in, T, 64, dxz, part)}
    plain = {
        "ssd_front": lambda: ref.ssd_front_ref(*front_in),
        "ssd_back": lambda: ref.ssd_back_ref(*back_in, 64),
        "ssd_back_bwd": lambda: ref.ssd_back_bwd_ref(dy, *back_in, rstd, 64),
        "ssd_front_bwd": lambda: ref.ssd_front_bwd_ref(*fb_in, T, 64)}
    # The composition: forward of each part, then autograd of each part.
    front, back, st = _ssd_composition(xz, dt_raw, bt, ct, conv_w, conv_b,
                                       dt_b, a_log, d_skip, out_norm, T)
    f_ins = [t.detach().requires_grad_(True) for t in (xz, dt_raw, bt, ct)]
    f_outs = front(*f_ins)
    f_grads = [torch.randn(t.shape, generator=g, device=dev) for t in f_outs]
    o = back_in[0]
    b_ins = [o.transpose(1, 2).detach().requires_grad_(True), f_outs[2],
             st["xh"], st["z"], st["b32"], st["c32"]]
    y = back(*b_ins)
    compose = {
        "ssd_front": lambda: front(xz, dt_raw, bt, ct),
        "ssd_back": lambda: back(*(t.detach() for t in b_ins)),
        "ssd_back_bwd": lambda: torch.autograd.grad(
            y, b_ins, dy, retain_graph=True),
        "ssd_front_bwd": lambda: torch.autograd.grad(
            f_outs, f_ins, f_grads, retain_graph=True)}
    n, s = G * B * T, xz.element_size()
    xs_b, row_b = n * E * s, n * E * 4
    small = _ssd_bytes(dt_raw, bt, ct)
    xh, dt, logw = io["f_want"][0], io["f_want"][4], io["f_want"][5]
    fb_got = io["fb_got"]
    # The per-tile partials (`kernels/ssd.py`): the conv's and the heads'
    # from ssd_front_bwd, out_norm's from ssd_back_bwd.
    front_tiles = G * B * -(-T // ssd.ROWS_FRONT)
    conv_part = front_tiles * (4 + 1) * E * 4
    head_part = front_tiles * 3 * H * 4
    weights = (conv_w, conv_b, dt_b, a_log, d_skip)
    moved = {
        "ssd_front": xs_b + small + _ssd_bytes(conv_tail, *weights[:4])
        + _ssd_bytes(*io["f_want"]),
        "ssd_back": _ssd_bytes(o, xh) + xs_b + _ssd_bytes(bt, ct, dt, d_skip,
                                                         out_norm)
        + _ssd_bytes(*io["b_want"]),
        "ssd_back_bwd": _ssd_bytes(dy, o, xh) + xs_b
        + _ssd_bytes(bt, ct, dt, rstd, d_skip, out_norm) + row_b + xs_b
        + _ssd_bytes(io["p2"], part),
        "ssd_front_bwd": row_b + _ssd_bytes(io["dv"], io["dr"], io["dlw"],
                                            io["p2"], dt, logw)
        + xs_b + small + _ssd_bytes(conv_tail, *weights) + xs_b
        + _ssd_bytes(fb_got[0], fb_got[9]) + conv_part + head_part,
        "ssd_reduce": conv_part + head_part + _ssd_bytes(part)
        + _ssd_bytes(dt, io["p2"], io["dk"], io["dr"], logw, bt, ct)
        + _ssd_bytes(*fb_got[1:9])}
    times = {name: device_ms(fn) for name, fn in run.items()}
    call_ms = times["ssd_front_bwd"]
    split = _kernel_ms(run["ssd_front_bwd"], "ssd_front_bwd_kernel",
                       "ssd_reduce_kernel")
    times.update(ssd_front_bwd=split["ssd_front_bwd_kernel"],
                 ssd_reduce=split["ssd_reduce_kernel"])
    rows = []
    for name in SSD_KERNELS:
        b_ms, b_by = bound_ms(moved[name], 0)
        rows.append(dict(
            name=name, case=case, G=G, B=B, T=T, E=E, H=H, dtype=dtype,
            tail=tail, max_rel_err=errs[name], tol=SSD_TOL[dtype],
            deterministic=True, ms=times[name],
            call_ms=call_ms if name in ("ssd_front_bwd", "ssd_reduce")
            else None,
            plain_ms=device_ms(plain[name]) if name in plain else None,
            composition_ms=(device_ms(compose[name]) if name in compose
                            else None),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            bytes=moved[name]))
    return rows


def check_ssd_shape(dev, key: tuple, chain: dict) -> list[dict]:
    """The SSD kernels against their plain versions (`_ssd_chain`, no
    timing) on random inputs laid out as a path's launches were
    (`_ssd_chains`): xz, B and C as recorded, and each other tensor (the
    per-client weights with their client strides, dt_raw, the conv tail or
    none) in every layout recorded beside them, one variant a row, so
    that each recorded layout runs in at least one; a tensor that no
    launch of the path passed is drawn dense."""
    xz_l, bt_l, ct_l, T = key
    (G, n, E2), dtype = xz_l[0], xz_l[3]
    E = E2 // 2
    H = E // 64

    def dense(*shape):
        return (shape, _dense_strides(shape), 0, dtype)

    default = dict(dt_raw=dense(G, n, H), conv_w=dense(G, 4, E),
                   conv_b=dense(G, E), dt_b=dense(G, H), a_log=dense(G, H),
                   d_skip=dense(G, H), out_norm=dense(G, E), conv_tail=None)
    # Each tensor's (scale, shift) of a normal draw: `_ssd_inputs`' scales.
    draw = dict(dt_raw=(0.5, 0.0), conv_w=(0.1, 0.0), conv_b=(0.1, 0.0),
                dt_b=(0.1, -2.0), a_log=(0.5, 1.0), d_skip=(0.1, 1.0),
                out_norm=(0.1, 0.0), conv_tail=(1.0, 0.0))
    layouts = {k: sorted(chain["layouts"].get(k, {v}), key=str)
               for k, v in default.items()}
    rows = []
    for i in range(max(map(len, layouts.values()))):
        g = torch.Generator(device=dev).manual_seed(G * n * E2 + T + i)
        pick = {k: v[min(i, len(v) - 1)] for k, v in layouts.items()}
        t = {k: None if lay is None else _strided(
                 lay, g, dev, scale=draw[k][0], shift=draw[k][1])
             for k, lay in pick.items()}
        errs, _ = _ssd_chain(
            dev, g, _strided(xz_l, g, dev), t["dt_raw"],
            _strided(bt_l, g, dev, scale=0.3), _strided(ct_l, g, dev,
                                                        scale=0.3),
            t["conv_w"], t["conv_b"], t["dt_b"], t["a_log"], t["d_skip"],
            t["out_norm"], t["conv_tail"], T)
        strides = sorted({f"{k}:{lay[1][0]}" for k, lay in pick.items()
                          if lay is not None and k in _WEIGHT_NAMES
                          and lay[1] != _dense_strides(lay[0])})
        offsets = sorted({f"{k}:{lay[2]}" for k, lay in pick.items()
                          if lay is not None and lay[2]})
        rows.append(dict(
            name="ssd", max_rel_err=max(errs.values()),
            label=(f"ssd G={G} B={n // T} T={T} E={E} {dtype}"
                   + (" tail" if pick["conv_tail"] is not None else "")
                   + (f" client strides {','.join(strides)}" if strides
                      else "")
                   + (f" offsets {','.join(offsets)}" if offsets else "")
                   + f" ({', '.join(sorted(chain['launchers']))})")))
    return rows


_WEIGHT_NAMES = ("conv_w", "conv_b", "dt_b", "a_log", "d_skip", "out_norm")
# The tensors besides xz, B and C that a path's SSD launches pass, by the
# launchers' argument names.
_SSD_CHAIN_TENSORS = ("dt_raw", "conv_tail") + _WEIGHT_NAMES


def _ssd_layout(layout: tuple | None) -> tuple | None:
    """A recorded layout as the kernels see it: the storage offset only
    as its alignment (in elements, modulo 16 bytes), and a single
    client's client stride as the dense one, which no address uses."""
    if layout is None:
        return None
    shape, stride, offset, dtype = layout
    if shape[0] == 1:
        stride = _dense_strides(shape)[:1] + stride[1:]
    return (shape, stride,
            offset % (16 // getattr(torch, dtype).itemsize), dtype)


def _ssd_chains(rec: LaunchShapes) -> dict[tuple, dict]:
    """A path's recorded SSD launches, grouped by the rows they ran: the
    layouts of xz, B and C and the sequence length. For each, the
    launchers that ran there and every layout (`_ssd_layout`) each other
    tensor came in (None for an absent conv tail)."""
    chains: dict[tuple, dict] = {}
    for name in SSD_LAUNCHERS:
        for launch in rec.lm[name]:
            a = {k: _ssd_layout(v) if k in _SSD_CHAIN_TENSORS + (
                "xz", "bt", "ct") else v for k, v in launch}
            T = a["seq_len"] if "seq_len" in a else a["o"][0][1]
            c = chains.setdefault((a["xz"], a["bt"], a["ct"], T),
                                  dict(launchers=set(), layouts={}))
            c["launchers"].add(name)
            for k in _SSD_CHAIN_TENSORS:
                if k in a:
                    c["layouts"].setdefault(k, set()).add(a[k])
    return chains


def _token_batch(cfg, seed: int, dev, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> dict:
    """A batch of the launcher's data (its Markov chains and, where the
    config takes them, its zero frame or prefix embeddings), on `dev`."""
    toks = synthetic_token_batch(batch, seq, cfg.vocab_size, seed=seed)
    return {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev),
            **train.stub_embeds(cfg, batch, dev)}


def _launcher_steps(cfg, dev, batch: int, seq: int) -> dict:
    """The launcher's loop (`train.main`) for a config it cannot name (a
    depth cut): TRAIN_STEPS AdamW steps at TRAIN_LR from seeded weights on
    fresh batches, each in a `launch.train_step` span ending in a device
    sync. Returns its `train.done` fields."""
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adam_init(params)
    step = make_train_step(cfg, lr=TRAIN_LR, remat=False)
    rng = np.random.default_rng(0)
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        data = _token_batch(cfg, int(rng.integers(1 << 30)), dev, batch, seq)
        t0 = time.perf_counter()
        with obs.span("launch.train_step", step=i):
            params, opt, metrics = step(params, opt, data)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        obs.count("launch.train_tokens", batch * seq)
    s_per_step = sum(step_s[1:]) / (TRAIN_STEPS - 1)
    return dict(losses=losses, s_per_step=s_per_step,
                tokens_per_s=batch * seq / s_per_step)


def phase_lm_train(dev, arch: str = TRAIN_ARCH, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ, cut=None,
                   name: str = "lm_train") -> dict:
    """`repro_torch.launch.train.main` on a full-width `arch` (bf16,
    random weights from a seed; hymba-1.5b, rwkv6-1.6b, whisper-medium
    with zero frames) at its default lr, or, for `cut`, a depth cut of
    its config (llava-next-mistral-7b: every published width, 4 of 32
    layers; deepseek-v3: its 3 dense layers), the launcher's loop
    (`_launcher_steps`), traced, with the
    launch counters zeroed just before and read just after: one launch
    of each LM kernel its layers run, and of its backward, a layer a
    step. Then the same configuration from the same weights on one fixed
    batch: its initial loss on TRAIN_STEPS other batches (the spread the
    batch alone gives), TRAIN_STEPS steps (two plain, wall; one under
    torch.profiler: device busy time, idle share and time by kernel; one
    plain) and the loss after them, which must fall by more than
    TRAIN_DROP_SPREADS spreads: the full-width gradient trains the
    model. Tokens are text tokens (`batch` x `seq`)."""
    cfg = get_config(arch) if cut is None else cut
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                 # the training path's counts
    t0 = time.perf_counter()
    with obs.tracing():
        if cut is None:
            done = train.main([
                "--arch", arch, "--full-config", "--device", "cuda",
                "--batch", str(batch), "--seq", str(seq),
                "--steps", str(TRAIN_STEPS)])
        else:
            done = _launcher_steps(cfg, dev, batch, seq)
        summary = obs.metrics_summary()
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * TRAIN_STEPS for k, n in _layer_launches(cfg).items()}
    # a recomputed layer's forward again in the backward
    want["wkv6"] += recomputed_layers(cfg, getattr(torch, cfg.dtype)) \
        * TRAIN_STEPS
    require(all(launches[k] == n for k, n in want.items()),
            f"train {arch} launched {launches}; expected {want}")
    losses = done["losses"]
    require(len(losses) == TRAIN_STEPS
            and all(math.isfinite(x) for x in losses),
            f"train losses not finite: {losses}")
    counters = summary["counters"]
    require(counters.get("launch.train_tokens")
            == TRAIN_STEPS * batch * seq,
            f"train counters: {counters}")
    spans = summary["spans"]["launch.train_step"]

    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    with torch.no_grad():
        spread_losses = [float(lm_loss(cfg, params, _token_batch(
            cfg, s, dev, batch, seq))[0]) for s in range(1, TRAIN_STEPS + 1)]
    spread = max(spread_losses) - min(spread_losses)
    opt = adam_init(params)
    train_step = make_train_step(cfg, lr=TRAIN_LR, remat=False)
    fixed = _token_batch(cfg, 0, dev, batch, seq)
    fixed_losses, walls = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        if i == 2:
            with _device_profile() as prof:
                params, opt, metrics = train_step(params, opt, fixed)
                torch.cuda.synchronize()
            profiled = dict(wall_s=walls[-1], **_device_time(prof,
                                                             walls[-1]))
            del prof
        else:
            params, opt, metrics = train_step(params, opt, fixed)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fixed_losses.append(float(metrics["loss"]))
    with torch.no_grad():
        fixed_losses.append(float(lm_loss(cfg, params, fixed)[0]))
    drop = fixed_losses[0] - fixed_losses[-1]
    require(all(math.isfinite(x) for x in fixed_losses)
            and drop > TRAIN_DROP_SPREADS * spread,
            f"fixed-batch losses {fixed_losses} fell by {drop}, not more "
            f"than {TRAIN_DROP_SPREADS} x the spread {spread} of "
            f"{spread_losses}")
    n_params = count_params(params)
    del params, opt
    torch.cuda.empty_cache()
    out = dict(
        arch=arch, n_layers=cfg.n_layers, dtype=cfg.dtype, batch=batch,
        seq=seq, prefix_len=cfg.n_prefix_tokens,
        frames=cfg.encoder.n_frames if cfg.encoder is not None else 0,
        steps=TRAIN_STEPS, lr=TRAIN_LR, losses=losses,
        launches=launches, main_wall_s=main_wall,
        s_per_step=done["s_per_step"], tokens_per_s=done["tokens_per_s"],
        step_span_s=dict(count=spans["count"], total_s=spans["total_s"]),
        peak_device_memory_bytes=peak, params=n_params,
        initial_loss_by_batch=spread_losses, initial_loss_spread=spread,
        fixed_batch_losses=fixed_losses, fixed_batch_drop=drop,
        plain_step_walls_s=walls, profiled_step=profiled)
    emit(name, **out)
    return out


def _fixed_step(cfg, dev, remat: bool) -> tuple[list, dict]:
    """One AdamW step at TRAIN_LR from the seed-0 weights on the fixed
    batch (`phase_lm_train`'s first fixed-batch step), with or without
    remat, launch counters zeroed just before and read just after.
    Returns the updated params' leaves, moved to the host, and the
    step's loss, launches and peak device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adam_init(params)
    fixed = _token_batch(cfg, 0, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    params, opt, metrics = make_train_step(cfg, lr=TRAIN_LR, remat=remat)(
        params, opt, fixed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(loss=float(metrics["loss"]), launches=dict(ops.LAUNCHES),
               peak_device_memory_bytes=torch.cuda.max_memory_allocated(),
               wall_s=wall)
    del opt
    leaves = [t.cpu() for t in _leaves_of(params)]
    del params
    torch.cuda.empty_cache()
    return leaves, out


def phase_lm_train_mla(dev) -> dict:
    """deepseek-v3 at every published width (d 7168, 128 MLA heads of
    (192, 128), q / kv latents of 1536 / 512, d_ff 18,432, vocab 129,280,
    untied head and the MTP head; bf16) with its depth cut to its 3 dense
    layers (MLA_TRAIN_PARAMS), trained as `phase_lm_train` says at 2 x
    2048: 3 flash_attention and 3 flash_attention_bwd launches a step, the
    backward at (192, 128) on the tensor cores. Then `remat` on the card:
    one step from the same weights and batch without and with it (each
    layer recomputed in the backward): both losses, the updated params
    within one bf16 rounding an element of each other, the forward
    launched twice a layer with remat, both peak memories."""
    cfg = dataclasses.replace(
        get_config(MLA_ARCH), n_layers=MLA_TRAIN_LAYERS,
        segments=(Segment("attn", MLA_TRAIN_LAYERS),))
    out = phase_lm_train(dev, MLA_ARCH, TRAIN_BATCH, TRAIN_SEQ, cfg,
                         "lm_train_mla")
    require(out["params"] == MLA_TRAIN_PARAMS,
            f"lm_train_mla: {out['params']} params; the reference counts "
            f"{MLA_TRAIN_PARAMS:,}")
    plain_leaves, plain = _fixed_step(cfg, dev, remat=False)
    remat_leaves, remat = _fixed_step(cfg, dev, remat=True)
    gap = ulps = 0.0
    for a, b in zip(remat_leaves, plain_leaves):
        a, b = a.to(dev).float(), b.to(dev).float()
        d = (a - b).abs()
        gap = max(gap, float(d.max()))
        ulps = max(ulps, float((d / _ulp_bf16(b)).max()))
    del plain_leaves, remat_leaves
    n = MLA_TRAIN_LAYERS
    for run, fwd in ((plain, n), (remat, 2 * n)):
        want = {"flash_attention": fwd, "flash_attention_bwd": n}
        require(all(run["launches"][k] == v for k, v in want.items())
                and math.isfinite(run["loss"]),
                f"lm_train_mla remat step: {run}; expected launches {want}")
    require(ulps <= 1.0,
            f"lm_train_mla: the remat step's params are {ulps} bf16 "
            f"roundings (max |diff| {gap}) from the plain step's")
    rout = dict(plain=plain, remat=remat, loss_diff=remat["loss"]
                - plain["loss"], params_max_abs_diff=gap,
                params_max_diff_bf16_ulps=ulps)
    emit("lm_train_mla_remat", **rout)
    return dict(out, remat=rout)


# ------------------------------------------------- the round as a pod
# make_fl_round_step on full-width hymba-1.5b: one pod, its local steps,
# the proximal coefficient.
ROUND_ARCH, ROUND_STEPS, ROUND_MU = "hymba-1.5b", 2, 0.01


def _leaves_of(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    map_tree(out.append, tree)
    return out


def _rebuild(tree, leaves: list[torch.Tensor]):
    """`tree`'s structure with `leaves` (in `_leaves_of` order)."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), tree)


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in _leaves_of(tree)])


# The round's delta must agree with the oracle's to one bfloat16 rounding
# of the result an element, and in L2 within this fraction of the
# oracle's delta (a round at half the lr, or with the delta's sign
# flipped, is far outside it: the phase checks that it is).
ROUND_DELTA_REL_L2 = 0.125


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _round_delta(params, out, want_flat: torch.Tensor,
                 sign: float = 1.0) -> dict:
    """The round's delta sign * (out - params) against the oracle's
    (want - params), leaf by leaf in f32: the elements the oracle moves
    and its largest move, the elements that differ, the largest
    difference in units of bfloat16's spacing at the result, and the
    difference's L2 norm over the oracle delta's."""
    moved = differ = 0
    max_moved = max_ulps = sq_err = sq_ref = 0.0
    off = 0
    for p, o in zip(_leaves_of(params), _leaves_of(out)):
        n = p.numel()
        pf = p.float()
        want = want_flat[off:off + n].view_as(p).float()
        off += n
        d, dw = sign * (o.float() - pf), want - pf
        err = (d - dw).abs()
        mag = torch.maximum(torch.maximum(pf.abs(), want.abs()),
                            (pf + d).abs())
        moved += int((dw != 0).sum())
        differ += int((err != 0).sum())
        max_moved = max(max_moved, float(dw.abs().max()))
        max_ulps = max(max_ulps, float((err / _ulp_bf16(mag)).max()))
        sq_err += float(err.double().square().sum())
        sq_ref += float(dw.double().square().sum())
    return dict(moved=moved, max_moved=max_moved, differ=differ,
                max_ulps=max_ulps,
                rel_l2=(sq_err / sq_ref) ** 0.5 if sq_ref else math.inf)


def _delta_agrees(stats: dict) -> bool:
    return (stats["moved"] > 0 and stats["max_ulps"] <= 1.0
            and stats["rel_l2"] <= ROUND_DELTA_REL_L2)


def phase_mesh_lm_round(dev) -> dict:
    """`launch.fl_round.make_fl_round_step` on full-width hymba-1.5b
    (bf16, random weights from a seed) as one pod of a one-rank NCCL
    group: ROUND_STEPS local proximal SGD steps (mu ROUND_MU, the
    launcher's lr) on a (2, 2048) batch of the launcher's data, then the
    masked all-reduce. One warm round, then one timed with the launch
    and collective counters zeroed just before and read just after (a
    launch of each LM kernel a layer a local step) and the peak device
    memory. Weight 0 and steps 0 must each give the params back bit for
    bit. With weight > 0 the round's delta (out - params) is held
    against an oracle's: two plain SGD steps computed separately, in the
    params' dtype as the reference computes them, then
    `weighted_delta_update` (the fedagg kernel's delta form) on the card.
    Each element within one bfloat16 rounding of the result, and the
    delta's L2 error within ROUND_DELTA_REL_L2 of the oracle delta's.
    The same check must reject the round at half the lr and the round
    with its delta's sign flipped. The proximal term's reach is reported
    (the elements a round at mu 0 leaves elsewhere)."""
    cfg = get_config(ROUND_ARCH)
    _nccl_group(dev)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = _token_batch(cfg, 0, dev, TRAIN_BATCH, TRAIN_SEQ)
    step = make_fl_round_step(cfg, lr=TRAIN_LR, local_steps=ROUND_STEPS,
                              prox_mu=ROUND_MU)
    w = [float(TRAIN_BATCH * TRAIN_SEQ)]
    step(params, batch, w)                      # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                        # this path's counts
    reset_collectives()
    t0 = time.perf_counter()
    out = step(params, batch, w)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches, colls = dict(ops.LAUNCHES), dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * ROUND_STEPS for k, n in _layer_launches(cfg).items()}
    require(all(launches[k] == n for k, n in want.items()),
            f"fl round launched {launches}; expected {want}")
    require(colls["all_reduce"] == 2,
            f"fl round collectives {colls}: expected the weights' total "
            "and one bf16 bucket")
    moved = float(max((a.float() - b.float()).abs().max() for a, b in
                      zip(_leaves_of(out), _leaves_of(params))))
    require(moved > 0, "a participating round left the params unchanged")
    for label, kw in (("weight 0", dict(weights=[0.0])),
                      ("steps 0", dict(weights=w, steps=[0]))):
        same = step(params, batch, **kw)
        require(all(torch.equal(a, b) for a, b in
                    zip(_leaves_of(same), _leaves_of(params))),
                f"{label}: the params moved")
        del same
    # The oracle: plain SGD steps in the params' dtype (the reference's
    # p - lr * (g + mu * (p - p0))), then the host path's server update.
    anchors = _leaves_of(params)
    leaves = [p.detach().clone() for p in anchors]
    for _ in range(ROUND_STEPS):
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(
            lm_loss(cfg, _rebuild(params, leaves), batch)[0], leaves)
        with torch.no_grad():
            leaves = [p - TRAIN_LR * (g + ROUND_MU * (p - p0))
                      for p, g, p0 in zip(leaves, grads, anchors)]
        del grads
    local = _rebuild(params, leaves)
    del leaves
    with torch.no_grad():
        want_flat = weighted_delta_update(
            _flat(params), _flat(local)[None],
            torch.tensor(w, device=dev), torch.zeros(1, device=dev))
        del local
        delta = _round_delta(params, out, want_flat)
        flipped = _round_delta(params, out, want_flat, sign=-1.0)
    half = make_fl_round_step(cfg, lr=TRAIN_LR / 2, local_steps=ROUND_STEPS,
                              prox_mu=ROUND_MU)(params, batch, w)
    no_mu = make_fl_round_step(cfg, lr=TRAIN_LR, local_steps=ROUND_STEPS,
                               prox_mu=0.0)(params, batch, w)
    with torch.no_grad():
        half_lr = _round_delta(params, half, want_flat)
        del half
        mu_reach = sum(int((a != b).sum()) for a, b in
                       zip(_leaves_of(no_mu), _leaves_of(out)))
        del no_mu
    emit("mesh_lm_round_delta", delta=delta, flipped=flipped,
         half_lr=half_lr, mu_reach_elements=mu_reach,
         rel_l2_tol=ROUND_DELTA_REL_L2)
    require(_delta_agrees(delta),
            f"fl round's delta disagrees with the oracle's: {delta}")
    require(not _delta_agrees(flipped) and not _delta_agrees(half_lr),
            "the delta check passes a flipped or a half-lr round: "
            f"{flipped}, {half_lr}")
    n_params = count_params(params)
    del params, out, want_flat
    torch.cuda.empty_cache()
    res = dict(arch=ROUND_ARCH, params=n_params, dtype=cfg.dtype,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, local_steps=ROUND_STEPS,
               prox_mu=ROUND_MU, lr=TRAIN_LR, backend="nccl",
               round_s=round_s, peak_device_memory_bytes=peak,
               launches=launches, collectives=colls, params_max_moved=moved,
               identity_rounds_bitwise=True, delta=delta,
               delta_rel_l2_tol=ROUND_DELTA_REL_L2,
               rejects=dict(flipped=flipped, half_lr=half_lr),
               mu_reach_elements=mu_reach)
    emit("mesh_lm_round", **res)
    return res


# One grok-1 MoE block at full width (d 6144, 8 experts of 32,768, top-2,
# capacity factor 1.5, bf16) on x of (EP_BATCH, EP_SEQ, d).
EP_ARCH, EP_BATCH, EP_SEQ, EP_REPS = "grok-1-314b", 4, 2048, 5


def phase_ep_moe(dev) -> dict:
    """`apply_moe_ep` over a one-rank NCCL group against `apply_moe` on
    the one-row view (B * S tokens as one row: the same capacity, drops
    included): output, aux and the gradients in x, the router and the
    experts within the bf16 tolerance; forward and backward ms (CUDA
    events, median of EP_REPS after a warm run) of both, and the
    all-to-all bytes of one forward and backward."""
    cfg = get_config(EP_ARCH)
    group = _nccl_group(dev)
    d = cfg.d_model
    g = torch.Generator(dev).manual_seed(0)
    p = init_moe(g, d, cfg.moe, cfg.mlp, device=dev, dtype=torch.bfloat16)
    x = torch.randn((EP_BATCH, EP_SEQ, d), generator=g, device=dev
                    ).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    leaves = _leaves_of(p)
    for t in leaves:
        t.requires_grad_(True)
    xx = x.clone().requires_grad_(True)

    def forward(ep: bool):
        if ep:
            return apply_moe_ep(p, xx, cfg.moe, cfg.mlp, group)
        y, aux = apply_moe(p, xx.reshape(1, -1, d), cfg.moe, cfg.mlp)
        return y.view(x.shape), aux

    def run(ep: bool):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        y, aux = forward(ep)
        e[1].record()
        loss = (y.float() * dy.float()).sum() + aux["load_balance"] \
            + aux["router_z"]
        grads = torch.autograd.grad(loss, [xx] + leaves)
        e[2].record()
        torch.cuda.synchronize()
        return (y.detach(), {k: v.detach() for k, v in aux.items()},
                grads, e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))

    res = {}
    for ep in (True, False):
        run(ep)                                 # warm
        fwd, bwd = [], []
        for _ in range(EP_REPS):
            reset_collectives()
            y, aux, grads, f_ms, b_ms = run(ep)
            fwd.append(f_ms)
            bwd.append(b_ms)
        res[ep] = (y, aux, grads, statistics.median(fwd),
                   statistics.median(bwd), dict(COLLECTIVES))
        del y, aux, grads
    (y, aux, grads, f_ms, b_ms, colls), (y1, aux1, grads1, f1, b1, _) = \
        res[True], res[False]
    require(colls["all_to_all"] == 4,
            f"EP: {colls['all_to_all']} all-to-alls a forward and backward")
    tol = TOL["bfloat16"]
    err = dict(y=_max_err(y, y1, tol))
    for k in aux:
        err[k] = _max_err(aux[k], aux1[k], tol)
    names = ["x"] + list(p)               # router, w1, w2: no nesting
    for name, a, b in zip(names, grads, grads1):
        scale = max(1.0, float(b.float().abs().max()))
        err[f"grad_{name}"] = _max_err(a, b, tol, tol * scale)
    E, K, cf = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    C = int(max(1, round(EP_BATCH * EP_SEQ * K * cf / E)))
    del p, leaves, xx, grads, grads1
    torch.cuda.empty_cache()
    out = dict(arch=EP_ARCH, d_model=d, n_experts=E, d_ff_expert=cfg.moe
               .d_ff_expert, top_k=K, capacity_factor=cf, capacity=C,
               x_shape=list(x.shape), dtype="bfloat16", backend="nccl",
               ep_forward_ms=f_ms, ep_backward_ms=b_ms,
               row_local_forward_ms=f1, row_local_backward_ms=b1,
               all_to_all=colls["all_to_all"],
               all_to_all_bytes=colls["all_to_all_bytes"],
               all_to_all_bytes_each=E * C * d * 2, max_abs_err=err,
               tol=tol)
    emit("ep_moe", **out)
    return out


# Each LM workload's (attention layers, scan layers, SSD heads): lm_tiny
# 2 attention layers, lm_hybrid_tiny 2 hybrid (attention + SSD heads),
# lm_rwkv6_tiny 2 RWKV6 time mixes, lm_moe_tiny 4 MLA layers (flash at
# (96, 64)).
LM_FL_LAYERS = {"lm_tiny": (2, 0, 0), "lm_hybrid_tiny": (2, 2, 2),
                "lm_rwkv6_tiny": (0, 2, 0), "lm_moe_tiny": (4, 0, 0)}


def phase_lm_fl(dev) -> dict:
    """ConstellationSim.run() for fedavg and fedprox on lm_tiny,
    lm_hybrid_tiny, lm_rwkv6_tiny and lm_moe_tiny (c2s2/g1, 2 days),
    launch counters
    zeroed before and read after each run: one prox_sgd launch a local
    step and one fedagg a round; one flash_attention launch per attention
    layer per local step and per evaluation for the whole client stack,
    and one flash_attention_bwd per layer per local step (wkv6 and
    wkv6_bwd likewise per SSD or RWKV6 layer, and the SSD kernels per
    SSD layer)."""
    out = {}
    for name, (n_attn, n_scan, n_ssd) in LM_FL_LAYERS.items():
        wl = get_workload(name)
        for alg in ("fedavg", "fedprox"):
            sim = ConstellationSim(
                WalkerStar(2, 2), station_subnetwork(1), ALGORITHMS[alg],
                cfg=SimConfig(max_rounds=LM_FL_ROUNDS,
                              horizon_s=LM_FL_HORIZON_S,
                              batch_size=LM_FL_BATCH),
                workload=name, device=dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            label = f"{name}/{alg}"
            expected = _expected_launches([res], [sim])
            steps, evals = expected["prox_sgd"], len(res.accuracy_curve)
            want = dict(expected, flash_attention=n_attn * (steps + evals),
                        flash_attention_bwd=n_attn * steps,
                        wkv6=n_scan * (steps + evals),
                        wkv6_bwd=n_scan * steps,
                        **{k: n_ssd * (steps + evals) for k in SSD_FORWARD},
                        **{k: n_ssd * steps for k in SSD_KERNELS
                           if k not in SSD_FORWARD})
            require(res.n_rounds >= 2, f"{label}: {res.n_rounds} rounds")
            require(launches == want,
                    f"{label}: launched {launches}, expected {want}")
            leaves = tree_leaves(res.final_params)
            require(sum(v.size for v in leaves) == wl.n_params
                    and all(bool(np.isfinite(v).all()) for v in leaves),
                    f"{label}: bad final params")
            accs = [a for *_, a in res.accuracy_curve]
            require(bool(accs) and all(math.isfinite(a) for a in accs),
                    f"{label}: accuracy not finite: {accs}")
            out[label] = dict(rounds=res.n_rounds, wall_s=wall,
                              n_params=wl.n_params, local_steps=steps,
                              evals=evals, accuracy=accs, launches=launches)
    emit("lm_fl", **out)
    return out


# ------------------------------------------------------------ lm_pricing
PRICING_HORIZON_S = 30 * 86400.0
PRICING_ROUNDS = 50
PRICING_ALGS = ("fedavg_sched", "fedbuff")


def phase_lm_pricing(dev) -> dict:
    """Every published LM at full width priced as a constellation client:
    `lm_workload(get_config(arch))` for all 10 archs (its layout from
    shapes on `meta`, nothing allocated; the wire at the config dtype's
    width), then timing-only `ConstellationSim` runs on the main path's
    cell over 30 days (fedavg_sched and fedbuff, at most 50 rounds) on
    the card and on the CPU with one `AccessWindows`, computed once on
    the card: RoundRecords identical; no kernel launches (timing only)."""
    cst, st = WalkerStar(10, 10), station_subnetwork(13)
    t0 = time.perf_counter()
    aw = compute_access_windows(cst, st, horizon_s=PRICING_HORIZON_S,
                                device=dev)
    torch.cuda.synchronize()
    windows_s = time.perf_counter() - t0
    ops.reset_launches()
    out = {}
    for arch in lm_arch_ids():
        t0 = time.perf_counter()
        wl = lm_workload(get_config(arch))
        hw = HardwareModel.for_workload(wl)
        row = dict(n_params=wl.n_params, model_mb=wl.model_bytes / 1e6,
                   transfer_s=hw.tx_time_s, epoch_s=hw.epoch_time_s,
                   trains=wl.train_refusal is None,
                   build_s=time.perf_counter() - t0)
        require(wl.n_params > 0 and wl.model_bytes == wl.n_params
                * wl.bytes_per_param, f"{arch}: bad workload cost")
        for alg in PRICING_ALGS:
            cfg = SimConfig(max_rounds=PRICING_ROUNDS,
                            horizon_s=PRICING_HORIZON_S, train=False)
            res, walls = {}, {}
            for where, device in (("card", dev), ("cpu", "cpu")):
                t0 = time.perf_counter()
                sim = ConstellationSim(cst, st, ALGORITHMS[alg], cfg=cfg,
                                       access=aw, workload=wl, device=device)
                res[where] = sim.run()
                walls[where] = time.perf_counter() - t0
            card = res["card"]
            require(_records(card) == _records(res["cpu"])
                    and card.total_time_s == res["cpu"].total_time_s,
                    f"{arch}/{alg}: the card's records differ from the "
                    "CPU's on the same windows")
            require(math.isfinite(card.total_time_s),
                    f"{arch}/{alg}: total time not finite")
            row[alg] = dict(rounds=card.n_rounds,
                            mean_round_h=card.mean_round_duration_s / 3600,
                            total_days=card.total_time_s / 86400,
                            wall_s=walls["card"], cpu_wall_s=walls["cpu"])
        out[arch] = row
    launches = dict(ops.LAUNCHES)
    require(not any(launches.values()),
            f"timing-only runs launched kernels: {launches}")
    out = dict(cell=MAIN_CELL, horizon_days=PRICING_HORIZON_S / 86400,
               max_rounds=PRICING_ROUNDS, windows_s=windows_s,
               archs=out, launches=launches)
    emit("lm_pricing", **out)
    return out


# -------------------------------------------------------------- examples
EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
# The sweep runs at its default 60 rounds unless that would take the
# phase past this wall; then at 20.
EXAMPLES_BUDGET_S = 60.0


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pytree_checks(dev) -> dict:
    """`fedagg_pytree` and `prox_sgd_pytree` once each on CUDA leaves (the
    reduced gemma-2b's tree, one leaf in bf16) against the same calls on
    CPU copies, which take the plain versions, at tests/test_kernels.py's
    tolerances; the launches counted: one fedagg, one prox_sgd a leaf."""
    cfg = get_config("gemma-2b").reduced()
    g = torch.Generator(device=dev).manual_seed(26)
    params = init_params(cfg, g, dev)
    params["final_norm"] = params["final_norm"].bfloat16()
    K = 4
    stacked = map_tree(lambda t: torch.randn(
        (K,) + tuple(t.shape), generator=g, device=dev).to(t.dtype), params)
    w = torch.softmax(torch.randn(K, generator=g, device=dev), 0)
    grads, anchor = (map_tree(lambda t: torch.randn(
        t.shape, generator=g, device=dev).to(t.dtype), params)
        for _ in range(2))
    cpu = lambda tree: map_tree(lambda t: t.cpu(), tree)
    ops.reset_launches()
    got_agg = ops.fedagg_pytree(stacked, w)
    got_prox = ops.prox_sgd_pytree(params, grads, anchor, 0.05, 0.1)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_leaves = len(tree_leaves(params))
    require(launches["fedagg"] == 1 and launches["prox_sgd"] == n_leaves,
            f"pytree forms launched {launches}, expected 1 fedagg and "
            f"{n_leaves} prox_sgd")
    want_agg = ops.fedagg_pytree(cpu(stacked), w.cpu())
    want_prox = ops.prox_sgd_pytree(cpu(params), cpu(grads), cpu(anchor),
                                    0.05, 0.1)
    errs = {}
    for name, got, want in (("fedagg_pytree", got_agg, want_agg),
                            ("prox_sgd_pytree", got_prox, want_prox)):
        errs[name] = max(
            _max_err(a.cpu(), b, TOL[str(b.dtype).removeprefix("torch.")])
            for a, b in zip(tree_leaves(got), tree_leaves(want)))
    return dict(leaves=n_leaves, launches=launches, max_abs_err=errs)


def phase_examples(dev) -> dict:
    """The four examples of `examples/torch/` through their `main`, on the
    card at their defaults, launch counters zeroed just before and read
    just after each: quickstart (prox_sgd, fedagg; accuracy climbing),
    constellation_llm with --execution host and mesh (the one-rank NCCL
    group; flash_attention and its backward, prox_sgd, fedagg; the two
    runs' RoundRecords identical, accuracies within 1e-5), serve_llm with
    gemma-2b (flash_attention) and rwkv6-1.6b (wkv6), and
    constellation_sweep (timing only: windows on the card) at its 60
    rounds, or at 20 if that would take the phase past
    EXAMPLES_BUDGET_S; then the pytree forms of the two simulator
    kernels against their plain versions."""
    t_phase = time.perf_counter()
    runs = {}

    def run(label: str, name: str, argv: list[str], must: tuple) -> dict:
        mod = _example(name)
        buf = io.StringIO()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        missing = [k for k in must if not launches[k]]
        require(not missing, f"examples/{label}: no launch of {missing}")
        require(got["device"].startswith(dev.type),
                f"examples/{label} ran on {got['device']}")
        runs[label] = dict(argv=argv, wall_s=wall, launches=launches,
                           stdout=buf.getvalue().splitlines())
        return got

    qs = run("quickstart", "quickstart", [], ("prox_sgd", "fedagg"))
    accs = [a for *_, a in qs["accuracy_curve"]]
    require(len(accs) >= 2 and all(math.isfinite(a) for a in accs)
            and accs[-1] > accs[0], f"quickstart: accuracy {accs}")
    llm = {}
    for ex in ("host", "mesh"):
        llm[ex] = run(f"constellation_llm_{ex}", "constellation_llm",
                      ["--execution", ex],
                      ("prox_sgd", "fedagg", "flash_attention",
                       "flash_attention_bwd"))
        require(llm[ex]["execution"] == ex and len(llm[ex]["rounds"]) >= 2,
                f"constellation_llm {ex}: {len(llm[ex]['rounds'])} rounds")
    host, mesh = ([[getattr(r, f) for f in RECORD_FIELDS] for r in
                   llm[ex]["rounds"]] for ex in ("host", "mesh"))
    require(host == mesh, "constellation_llm: mesh records differ from "
                          "the host run's")
    gaps = [abs(a - b) for (*_, a), (*_, b) in
            zip(llm["host"]["accuracy_curve"], llm["mesh"]["accuracy_curve"])]
    require(all(math.isfinite(x) and x <= 1e-5 for x in gaps),
            f"constellation_llm: mesh accuracy {gaps} from the host run's")
    for arch, kernel in (("gemma-2b", "flash_attention"),
                         ("rwkv6-1.6b", "wkv6")):
        got = run(f"serve_llm_{arch}", "serve_llm", ["--arch", arch],
                  (kernel,))
        cfg = get_config(arch).reduced()
        toks = got["tokens"]
        require(toks.shape == (4, 33) and toks.min() >= 0
                and toks.max() < cfg.vocab_size,
                f"serve_llm {arch}: tokens {toks.shape}")
    rounds = 60
    if time.perf_counter() - t_phase > EXAMPLES_BUDGET_S / 2:
        rounds = 20
    sweep = run("constellation_sweep", "constellation_sweep",
                ["--rounds", str(rounds)], ())
    cells = sweep["cells"]
    require(len(cells) == 12 and all(
        c["n_rounds"] > 0 and math.isfinite(c["total_s"])
        for c in cells.values()), "constellation_sweep: a cell ran no round")
    for g in (1, 3, 5, 13):
        require(cells[(g, "fedavg_sched")]["total_s"]
                <= cells[(g, "fedavg")]["total_s"],
                f"constellation_sweep g={g}: scheduling slowed FedAvg")
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in ops.LAUNCHES}
    out = dict(runs=runs, sweep_rounds=rounds, launches=total,
               pytree=_pytree_checks(dev))
    emit("examples", **out)
    return out


def _grads_of(cfg, params, toks, stub: dict):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, _ = lm_loss(cfg, params, {"tokens": toks, **stub})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def phase_lm_cpu_vs_card(dev) -> dict:
    """lm_tiny and lm_moe_tiny fedprox on the card and on the CPU from the
    same init and draws (made on the CPU): identical RoundRecords, final
    params within 1e-4; one training step (loss and every gradient leaf)
    of reduced hymba-1.5b, gemma-2b, rwkv6-1.6b, grok-1, whisper-medium
    (seeded random frames), llava-next-mistral-7b (seeded random prefix
    embeddings) and deepseek-v3 from the same weights and tokens, within
    1e-4 (of each leaf's largest gradient where that passes 1: rwkv6's
    embedding gradient reaches ~8.5, since its 0.02-scale rows are
    RMS-normed)."""
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    aw = compute_access_windows(cst, st, horizon_s=LM_FL_HORIZON_S,
                                device="cpu")
    cfg = SimConfig(max_rounds=LM_FL_ROUNDS, horizon_s=LM_FL_HORIZON_S,
                    eval_every=1, max_steps=8)
    out = {}
    for workload in ("lm_tiny", "lm_moe_tiny"):
        runs = {}
        for where, device, sampler in (
                ("cpu", "cpu", TorchSampler(0, "cpu")),
                ("card", dev, _OnDevice(TorchSampler(0, "cpu"), dev))):
            runs[where] = ConstellationSim(
                cst, st, ALGORITHMS["fedprox"], cfg=cfg, access=aw,
                workload=workload, device=device, sampler=sampler).run()
        recs = {k: _records(v) for k, v in runs.items()}
        require(len(recs["card"]) == LM_FL_ROUNDS
                and recs["card"] == recs["cpu"],
                f"{workload}: RoundRecords differ between the card and the "
                "CPU")
        flat = lambda r: np.concatenate([v.reshape(-1) for v in
                                         tree_leaves(r.final_params)])
        gap = float(np.abs(flat(runs["card"]) - flat(runs["cpu"])).max())
        out[workload] = dict(
            algorithm="fedprox", cell="c2s2/g1", records_identical=True,
            final_params_max_abs_gap=gap, tol=1e-4,
            accuracy_card=[a for *_, a in runs["card"].accuracy_curve],
            accuracy_cpu=[a for *_, a in runs["cpu"].accuracy_curve])
        require(gap <= 1e-4,
                f"{workload}: final params differ by {gap} > 1e-4")
    for arch, mcfg in _reduced_cfgs().items():
        cpu_params = init_params(mcfg, torch.Generator().manual_seed(0),
                                 "cpu")
        card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
        toks = torch.randint(0, mcfg.vocab_size, (2, 65),
                             generator=torch.Generator().manual_seed(1))
        loss_cpu, g_cpu = _grads_of(mcfg, cpu_params, toks,
                                    _stub_inputs(mcfg, 2, 3, "cpu"))
        loss_card, g_card = _grads_of(mcfg, card_params, toks.to(dev),
                                      _stub_inputs(mcfg, 2, 3, dev))
        grad_gap = max(float((a - b).abs().max())
                       for a, b in zip(g_card, g_cpu))
        # Each leaf's gap over max(1, its largest gradient).
        scaled_gap = max(float((a - b).abs().max())
                         / max(1.0, float(b.abs().max()))
                         for a, b in zip(g_card, g_cpu))
        out[arch] = dict(loss_gap=abs(loss_card - loss_cpu),
                         grad_max_abs_gap=grad_gap,
                         grad_max_scaled_gap=scaled_gap, tol=1e-4)
        require(abs(loss_card - loss_cpu) <= 1e-4 and scaled_gap <= 1e-4,
                f"{arch}: a train step differs between the card and the "
                f"CPU: loss {loss_card} vs {loss_cpu}, grads {grad_gap}")
    emit("lm_cpu_vs_card", **out)
    return out


# ------------------------------------------------------------------ main
# -------------------------------------------------------------- dry run
# The dry run's CLI pairs, each in a process of its own (it makes a fake
# process group of 256 or 512 ranks): the calibrated single-pod pair of
# the training cell's model, one multi-pod pair, and deepseek-v3's train
# and prefill pairs with and without the expert-parallel MoE.
EP_DRYRUN_ARCH = "deepseek-v3-671b"
DRYRUN_PAIRS = (("hymba-1.5b", "train_4k", ()),
                ("hymba-1.5b", "prefill_32k", ("--multi-pod",
                                               "--no-calibrate")),
                *((EP_DRYRUN_ARCH, shape, ("--no-calibrate", *ep))
                  for shape in ("train_4k", "prefill_32k")
                  for ep in ((), ("--ep",))))
DRYRUN_TIMEOUT_S = 300


def _ep_exchanges(r: dict) -> tuple[int, int]:
    """The token exchanges (count, bytes) an `--ep` pair of deepseek-v3
    on the 16 x 16 mesh issues: each E * C * d elements of the model's
    dtype, C = round(T_loc * K * cf / E) of a data shard's T_loc tokens;
    two a routed layer forward, two more backward and two again where
    remat recomputes the layer (the dry run's default)."""
    cfg = get_config(r["arch"])
    shape = INPUT_SHAPES[r["shape"]]
    mesh = mesh_consts.make_production_mesh()
    moe = cfg.moe
    T_loc = shape.global_batch // mesh.shape["data"] * shape.seq_len
    C = int(max(1, round(T_loc * moe.top_k * moe.capacity_factor
                         / moe.n_experts)))
    each = moe.n_experts * C * cfg.d_model * torch.finfo(
        getattr(torch, cfg.dtype)).bits // 8
    n = (6 if shape.kind == "train" else 2) * sum(
        s.n_layers for s in cfg.resolved_segments if s.kind == "moe")
    return n, n * each


def _dryrun_terms(cfg, shape, remat: bool) -> dict:
    """The dry run's count of one step of `cfg` at `shape` on one device
    (plain `meta` tensors, no group) and its roofline terms."""
    t0 = time.perf_counter()
    m, _ = dryrun.run_step(cfg, shape, mesh_consts.make_host_mesh(), None,
                           remat=remat)
    terms = roofline_terms({"chips": 1, "cost_flops": m.flops,
                            "cost_bytes": m.bytes, "collective_bytes": m.coll,
                            "model_flops": model_flops(cfg, shape)})
    return dict(flops=m.flops, bytes=m.bytes, count_s=time.perf_counter() - t0,
                bound_s=max(terms["compute_s"], terms["memory_s"],
                            terms["collective_s"]), **terms)


def phase_dryrun(trained: dict, served: dict) -> dict:
    """(b) `python -m repro_torch.launch.dryrun` on the production meshes,
    each pair in a process of its own (started first, run alongside (a));
    each must end `status: ok`, the calibrated one probe-checked. (a) The
    dry run's one-device count of the full-width hymba-1.5b training step
    at lm_train's shape (2 x 2048, bf16; with remat, the dry run's
    default, and without, as the launcher lm_train times it runs) and of
    serve's 4 x 2048 prefill, with the three roofline terms,
    useful_flops_ratio and measured/bound beside the times measured in
    this run: each measured time must be at least its compute term, and
    the training step's useful_flops_ratio in [0.5, 1.0]."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape, flags in DRYRUN_PAIRS:
        out = os.path.join(ROOT, "build", "dryrun_" + "_".join(
            (arch, shape, *(f.strip("-") for f in flags))) + ".json")
        if os.path.exists(out):
            os.remove(out)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out, *flags]
        procs.append((cmd, out, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)))
    cfg = get_config(TRAIN_ARCH)
    train_shape = InputShape("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    prefill_shape = InputShape("serve_prefill", SERVE_PROMPT, SERVE_BATCH,
                               "prefill")
    counts = {"train_remat": _dryrun_terms(cfg, train_shape, True),
              "train": _dryrun_terms(cfg, train_shape, False),
              "prefill": _dryrun_terms(cfg, prefill_shape, True)}
    measured = {"train": trained["s_per_step"],
                "prefill": served["prefill_ms_per_batch"] / 1e3}
    for name, t in measured.items():
        c = counts[name]
        c.update(measured_s=t, measured_over_bound=t / c["bound_s"],
                 measured_over_compute=t / c["compute_s"])
        require(t >= c["compute_s"],
                f"dry run: measured {name} {t} s is below its compute term "
                f"{c['compute_s']} s")
    for name in ("train", "train_remat"):
        ratio = counts[name]["useful_flops_ratio"]
        require(0.5 <= ratio <= 1.0,
                f"dry run: {name} useful_flops_ratio {ratio} outside "
                "[0.5, 1.0]")
    pairs = []
    t0 = time.perf_counter()
    for cmd, out, proc in procs:
        try:
            _, err = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                     - t0)))
        except subprocess.TimeoutExpired:
            for _, _, p in procs:
                p.kill()
                p.wait()
            raise SmokeFailure(f"dry run {cmd} still running after "
                               f"{DRYRUN_TIMEOUT_S} s")
        require(proc.returncode == 0 and os.path.exists(out),
                f"dry run {cmd} exited {proc.returncode}: {err[-2000:]}")
        with open(out) as f:
            (r,) = json.load(f)
        require(r["status"] == "ok", f"dry run {cmd}: {r}")
        if "--no-calibrate" not in cmd:
            require(r["calibration"].startswith("probe-checked"),
                    f"dry run {cmd}: {r['calibration']}")
        pairs.append(dict({k: r[k] for k in (
            "arch", "shape", "mesh", "chips", "status", "compile_s",
            "cost_flops", "cost_bytes", "collective_bytes", "calibration",
            "model_flops", "roofline", "memory") + tuple(
                k for k in ("ep_all_to_all", "ep_all_to_all_bytes")
                if k in r)}, ep="--ep" in cmd))
    for p in pairs:
        if p["arch"] != EP_DRYRUN_ARCH:
            continue
        if p["ep"]:
            n, nbytes = _ep_exchanges(p)
            require(p["ep_all_to_all"] == n
                    and p["ep_all_to_all_bytes"] == nbytes,
                    f"dry run --ep {p['shape']}: {p['ep_all_to_all']} "
                    f"exchanges of {p['ep_all_to_all_bytes']} bytes, "
                    f"expected {n} of {nbytes}")
            require(p["collective_bytes"]["all-to-all"] >= nbytes,
                    f"dry run --ep {p['shape']}: the count's all-to-all "
                    f"bytes {p['collective_bytes']['all-to-all']} miss "
                    f"the token exchanges' {nbytes}")
            (row,) = [q for q in pairs if q["arch"] == EP_DRYRUN_ARCH
                      and q["shape"] == p["shape"] and not q["ep"]]
            require(p["roofline"]["collective_s"]
                    < row["roofline"]["collective_s"],
                    f"dry run --ep {p['shape']}: collective term "
                    f"{p['roofline']['collective_s']} s not below the "
                    f"row-local {row['roofline']['collective_s']} s")
        print(json.dumps({"dryrun_row": {k: p.get(k) for k in (
            "arch", "shape", "mesh", "ep", "cost_flops", "cost_bytes",
            "collective_bytes", "ep_all_to_all", "ep_all_to_all_bytes",
            "roofline")}}), flush=True)
    out = dict(counts=counts, cli_pairs=pairs,
               cli_wall_s=time.perf_counter() - t0)
    emit("dryrun", **out)
    return out


def _pick(rows: list[dict], **match) -> dict:
    for r in rows:
        if all(r.get(k) == v for k, v in match.items()):
            return r
    raise SmokeFailure(f"no kernel row matches {match}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    phases_s: dict[str, float] = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases_s[name] = time.perf_counter() - t0
        return out

    timed("card", phase_card)
    rows = timed("kernels", phase_kernels, dev)
    setup = timed("main_path_setup", main_path_setup, dev)
    sim = ("fedagg", "prox_sgd")
    shapes = {name: LaunchShapes(*sim) for name in (
        "main_path", "mesh_path", "comms_path", "cnn_path",
        "batched_sweep")}
    shapes.update(serve=LaunchShapes("flash_attention", "wkv6",
                                     *SSD_FORWARD),
                  serve_rwkv=LaunchShapes("wkv6"),
                  serve_moe=LaunchShapes("flash_attention"),
                  serve_mla=LaunchShapes("flash_attention"),
                  serve_audio=LaunchShapes("flash_attention"),
                  serve_vlm=LaunchShapes("flash_attention"),
                  lm_fl=LaunchShapes(*sim, *LM_KERNELS, *SSD_KERNELS),
                  lm_train=LaunchShapes(*LM_KERNELS, *SSD_KERNELS),
                  lm_train_rwkv=LaunchShapes("wkv6", "wkv6_bwd"),
                  lm_train_audio=LaunchShapes("flash_attention",
                                              "flash_attention_bwd"),
                  lm_train_vlm=LaunchShapes("flash_attention",
                                            "flash_attention_bwd"),
                  lm_train_mla=LaunchShapes("flash_attention",
                                            "flash_attention_bwd"),
                  mesh_lm_round=LaunchShapes(*LM_KERNELS, *SSD_KERNELS),
                  examples=LaunchShapes(*sim, "flash_attention",
                                        "flash_attention_bwd", "wkv6"))
    with shapes["main_path"]:
        main_path = timed("main_path", phase_main_path, dev, setup)
    setup["main_path"] = main_path
    with shapes["mesh_path"]:
        mesh_path = timed("mesh_path", phase_mesh_path, dev, setup)
    timed("where_time_goes", phase_where_time_goes, dev, setup)
    timed("cpu_vs_card", phase_cpu_vs_card, dev)
    with shapes["comms_path"]:
        comms = timed("comms_path", phase_comms_path, dev, setup)
    with shapes["cnn_path"]:
        timed("cnn_path", phase_cnn_path, dev, setup)
    with shapes["batched_sweep"]:
        sweep = timed("batched_sweep", phase_batched_sweep, dev)
    with shapes["lm_fl"]:
        lm_fl = timed("lm_fl", phase_lm_fl, dev)
    timed("lm_pricing", phase_lm_pricing, dev)
    with shapes["examples"]:
        examples = timed("examples", phase_examples, dev)
    timed("comms_scale", phase_comms_scale, dev)
    timed("comms_cpu_vs_card", phase_comms_cpu_vs_card, dev)
    lm_rows = timed("lm_kernels", phase_lm_kernels, dev)
    with shapes["serve"]:
        served = timed("serve", phase_serve, dev)
    with shapes["serve_rwkv"]:
        served_rwkv = timed("serve_rwkv", phase_serve, dev, RWKV_ARCH,
                            "serve_rwkv")
    with shapes["serve_moe"]:
        served_moe = timed("serve_moe", phase_serve_moe, dev)
    with shapes["serve_mla"]:
        served_mla = timed("serve_mla", phase_serve_mla, dev)
    with shapes["serve_audio"]:
        served_audio = timed("serve_audio", phase_serve_audio, dev)
    with shapes["serve_vlm"]:
        served_vlm = timed("serve_vlm", phase_serve_vlm, dev)
    timed("serve_cpu_vs_card", phase_serve_cpu_vs_card, dev)
    train_rows = timed("lm_train_kernels", phase_lm_train_kernels, dev)
    with shapes["lm_train"]:
        trained = timed("lm_train", phase_lm_train, dev)
    with shapes["lm_train_rwkv"]:
        trained_rwkv = timed("lm_train_rwkv", phase_lm_train, dev, RWKV_ARCH,
                             TRAIN_BATCH, TRAIN_SEQ, None, "lm_train_rwkv")
    with shapes["lm_train_audio"]:
        trained_audio = timed("lm_train_audio", phase_lm_train, dev,
                              AUDIO_ARCH, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ,
                              None, "lm_train_audio")
    with shapes["lm_train_vlm"]:
        trained_vlm = timed("lm_train_vlm", phase_lm_train, dev, VLM_ARCH,
                            TRAIN_BATCH, TRAIN_SEQ, dataclasses.replace(
                                get_config(VLM_ARCH),
                                n_layers=VLM_TRAIN_LAYERS), "lm_train_vlm")
    with shapes["lm_train_mla"]:
        trained_mla = timed("lm_train_mla", phase_lm_train_mla, dev)
    with shapes["mesh_lm_round"]:
        lm_round = timed("mesh_lm_round", phase_mesh_lm_round, dev)
    timed("ep_moe", phase_ep_moe, dev)
    timed("path_shapes", phase_path_shapes, dev, shapes)
    timed("lm_cpu_vs_card", phase_lm_cpu_vs_card, dev)
    timed("dryrun", phase_dryrun, trained, served)

    # Main-path shapes: 10 clients per flush, femnist_mlp, f32.
    fed = _pick(rows, name="fedagg", form="plain", K=10, dtype="float32")
    prox = _pick(rows, name="prox_sgd", C=10, dtype="float32", mu=0.1,
                 anchor="shared")
    # Serving shapes: hymba-1.5b bf16, 29 of its 32 layers windowed.
    flash = _pick(lm_rows, name="flash_attention", case="serve_swa",
                  dtype="bfloat16")
    wkv = _pick(lm_rows, name="wkv6", case="serve")
    # Training shapes: full-width hymba-1.5b, bf16 attention (29 of its 32
    # layers windowed), the SSD heads' f32 scan in their broadcast layout.
    flash_bwd = _pick(train_rows, name="flash_attention_bwd",
                      case="train_swa")
    wkv_bwd = _pick(train_rows, name="wkv6_bwd", case="train")
    fl_total = {k: sum(run["launches"].get(k, 0) for run in lm_fl.values())
                for k in ops.LAUNCHES}
    # The serving paths (hymba-1.5b, rwkv6-1.6b, grok-1, deepseek-v3,
    # whisper-medium, llava) and the training paths (hymba-1.5b,
    # rwkv6-1.6b, whisper-medium, llava, deepseek-v3), each counted from 0.
    serve_runs = dict(serve=served, serve_rwkv=served_rwkv,
                      serve_moe=served_moe, serve_mla=served_mla,
                      serve_audio=served_audio, serve_vlm=served_vlm)
    train_runs = dict(lm_train=trained, lm_train_rwkv=trained_rwkv,
                      lm_train_audio=trained_audio, lm_train_vlm=trained_vlm,
                      lm_train_mla=trained_mla)
    serve_total = {k: sum(run["launches"][k] for run in serve_runs.values())
                   for k in ops.LAUNCHES}
    train_total = {k: sum(run["launches"][k] for run in train_runs.values())
                   for k in ops.LAUNCHES}
    # Each kernel's rows at the new paths' shapes (rwkv6's time mix through
    # the fixed and the generic build, grok-1's softcapped D = 128 heads,
    # MLA's (D, Dv) = (192, 128) serving and training and lm_moe_tiny's
    # (96, 64),
    # whisper's encoder and its cross-attention's keys of their own
    # length, llava's 4,928 positions in a 4,096 window).
    other = {"wkv6": [_pick(lm_rows, name="wkv6", case=c)
                      for c in ("rwkv_serve", "rwkv_serve_generic")],
             "flash_attention": [_pick(lm_rows, name="flash_attention",
                                       case=c)
                                 for c in ("grok_serve", "mla_serve",
                                           "mla_tiny", "whisper_encoder",
                                           "whisper_cross", "llava_serve")],
             "flash_attention_bwd": [_pick(train_rows,
                                           name="flash_attention_bwd", case=c)
                                     for c in ("mla_tiny", "mla_d192",
                                               "mla_train",
                                               "whisper_encoder",
                                               "whisper_cross")],
             "wkv6_bwd": [_pick(train_rows, name="wkv6_bwd",
                                case="rwkv6_train")]}
    # The mesh path's server update: fedagg's partial form at its shape.
    other["fedagg"] = [_pick(rows, name="fedagg", form="partial", K=10,
                             dtype="float32")]
    # The SSD kernels at the cell's step (hymba-1.5b, bf16, 4 x 2048), and
    # at their other shapes: a ragged f32 length, lm_hybrid_tiny's client
    # stack, three clients with a conv tail.
    ssd_rows = [_pick(train_rows, name=name, case="train")
                for name in SSD_KERNELS]
    for name in SSD_KERNELS:
        other[name] = [_pick(train_rows, name=name, case=c)
                       for c in ("ragged_f32", "lm_hybrid_tiny",
                                 "stack_tail")]
    row_keys = ("case", "build", "form", "G", "B", "T", "E", "K", "P", "S",
                "Sk", "D", "Dv", "tail", "max_abs_err", "max_rel_err", "ms",
                "call_ms", "plain_ms", "composition_ms", "bound_ms",
                "bound_by", "library_ms", "library_backend", "library_note")
    kernels = []
    for row, source, replaces, launches in (
            (prox, "src/repro_torch/csrc/prox_sgd.cu",
             "src/repro/kernels/prox_sgd.py:39", main_path["launches"]),
            (fed, "src/repro_torch/csrc/fedagg.cu",
             "src/repro/kernels/fedagg.py:38", main_path["launches"]),
            (flash, "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:114", serve_total),
            (wkv, "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/wkv6.py:90", serve_total),
            # No TPU kernel: the reference trains through jax.grad of
            # these jnp functions.
            (flash_bwd, "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/models/lm/attention.py:25", train_total),
            (wkv_bwd, "src/repro_torch/csrc/wkv6_bwd.cu",
             "src/repro/models/lm/scan_core.py:27", train_total),
            # The port's own: the reference leaves the SSD heads'
            # elementwise work to XLA's fusion.
            *((row, "src/repro_torch/csrc/" + (
                "ssd.cu" if row["name"] in SSD_FORWARD else "ssd_bwd.cu"),
               None, train_total) for row in ssd_rows)):
        kernels.append(dict(
            name=row["name"], route="cuda", source=source,
            replaces=replaces, launches=launches[row["name"]],
            max_abs_err=row.get("max_abs_err"),
            max_rel_err=row.get("max_rel_err"), ms=row["ms"],
            call_ms=row.get("call_ms"), plain_ms=row["plain_ms"],
            composition_ms=row.get("composition_ms"),
            bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            # The comms path's runs, each counted from 0 (not the main
            # path's count above), the batched sweep's femnist_cnn batch
            # (32 scenarios, counted from 0), the training path's 4
            # full-width steps and the LM constellation runs (each
            # counted from 0).
            comms_path_launches=comms["launches"].get(row["name"], 0),
            batched_sweep_launches=sweep["train"]["femnist_cnn"][
                "launches"].get(row["name"], 0),
            lm_fl_launches=fl_total.get(row["name"], 0),
            # The main path through execution="mesh" (8 runs) and the
            # full-width hymba-1.5b round as a pod, each counted from 0.
            mesh_path_launches=mesh_path["launches"][row["name"]],
            mesh_lm_round_launches=lm_round["launches"][row["name"]],
            # The four examples of examples/torch/, each counted from 0.
            examples_launches=examples["launches"][row["name"]],
            **{f"{path}_launches": run["launches"][row["name"]]
               for path, run in (serve_runs | train_runs).items()},
            other_shapes=[{k: r.get(k) for k in row_keys}
                          for r in other.get(row["name"], [])]))
    emit("done", wall_s=time.perf_counter() - t_start, phases_s=phases_s)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
