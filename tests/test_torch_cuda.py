"""The port's CUDA kernels and main path on a card (skipped without one).

Run on a machine with an NVIDIA Hopper card and `nvcc`:

    python -m pytest -q tests/test_torch_cuda.py

The kernels are built from `src/repro_torch/csrc/` at first use. Each is
held against its plain PyTorch version on the same card inputs with the
tolerances of `tests/test_kernels.py` (2e-5 in f32, 2e-2 in bf16;
flash_attention 3e-5 in f32, wkv6 2e-4), and flash_attention in bf16
within about one bf16 rounding step (rtol 8e-3, atol 1e-3). This file
imports neither `jax` nor `repro`, so it runs where only the port is
installed.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.comms import isl
from repro_torch.configs import get_config
from repro_torch.core import ALGORITHMS
from repro_torch.data import synth_femnist
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models.lm.params import lm_params_from_jax, \
    lm_params_to_numpy
from repro_torch.models.lm.transformer import init_params
from repro_torch.orbits import WalkerStar, compute_access_windows, \
    station_subnetwork
from repro_torch.orbits.access import visibility_grid
from repro_torch.orbits.propagation import (
    elevation_deg,
    eci_positions,
    gs_eci_positions,
)
from repro_torch.orbits.stations import station_latlon
from repro_torch.sim import ConstellationSim, SimConfig, TorchSampler

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
P_MLP = 46_639


@pytest.fixture
def dev() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda:0")


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float | None = None) -> None:
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=rtol if atol is None else atol)


def _ordered_fedagg(x, w, base=None, scale=1.0) -> torch.Tensor:
    """The kernel's f32 arithmetic as separate torch ops, each rounded
    once: acc = acc + w[k] * x[k] (or w[k] * (x[k] - base)) over k in
    order, then base + scale * acc."""
    xf = x.float()
    b = None if base is None else base.float()
    acc = torch.zeros(x.shape[1], device=x.device)
    for k in range(x.shape[0]):
        acc = acc + w[k] * (xf[k] if b is None else xf[k] - b)
    return acc if b is None else b + scale * acc


def _misaligned(dev, shape, dtype, shift, g) -> torch.Tensor:
    """A contiguous tensor of `shape` whose base pointer lies `shift`
    elements past a 16-byte boundary."""
    n = math.prod(shape)
    buf = torch.randn((n + shift,), generator=g, device=dev).to(dtype)
    return buf[shift:].view(shape)


# Odd row counts at femnist_mlp's odd width, one client, a width of 3
# (below a 16-byte vector) and 4099 (rows off 16 bytes).
SIM_SHAPES = [(10, P_MLP), (100, P_MLP), (1, P_MLP), (7, P_MLP),
              (13, P_MLP), (3, 4099), (2, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# Client counts on either side of the k loop's unrolled rounds and of
# powers of two, up to more clients than outputs.
@pytest.mark.parametrize("k,p", SIM_SHAPES + [
    (7, 12345), (1, 1), (16, 4099), (17, 4099), (33, 1000), (64, 777),
    (65, 4099), (128, 33), (129, 4099), (300, 777)])
@pytest.mark.parametrize("delta", [False, True])
def test_fedagg_kernel_matches_plain(dev, k, p, dtype, delta):
    """f32: bitwise the ordered sum; bf16: within 2e-2 of the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(k * p)
    x = torch.randn((k, p), generator=g, device=dev).to(dtype)
    w = torch.rand((k,), generator=g, device=dev)
    base = torch.randn((p,), generator=g, device=dev).to(dtype) \
        if delta else None
    scale = 0.5 if delta else 1.0
    before = ops.LAUNCHES["fedagg"]
    got = ops.fedagg_op(x, w, base, scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedagg"] == before + 1
    assert got.dtype == dtype and got.shape == (p,)
    _close(got, ref.fedagg_ref(x, w, base, scale), TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(got, _ordered_fedagg(x, w, base, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# Every odd width puts rows off 16 bytes: the kernel reads the flat stack
# in 16-byte vectors, and a vector may straddle a live and a masked row
# (the mask below alternates); (4, 4096) has aligned rows, (2, 3) is
# narrower than a vector and goes element by element.
@pytest.mark.parametrize("c,p", SIM_SHAPES + [(4, 4096), (11, P_MLP)])
@pytest.mark.parametrize("mu", [0.0, 0.1])
@pytest.mark.parametrize("shared_anchor", [True, False])
def test_prox_sgd_kernel_matches_plain(dev, c, p, dtype, mu, shared_anchor):
    """f32: bitwise the plain version (the same rounded ops in the same
    order); bf16: within 2e-2; masked rows bitwise untouched."""
    g = torch.Generator(device=dev).manual_seed(c + p)
    w = torch.randn((c, p), generator=g, device=dev).to(dtype)
    grad = torch.randn((c, p), generator=g, device=dev).to(dtype)
    anchor = torch.randn((p,) if shared_anchor else (c, p), generator=g,
                         device=dev).to(dtype)
    steps = torch.tensor([3 if i % 2 else 5 for i in range(c)],
                         dtype=torch.int32, device=dev)
    got, want = w.clone(), w.clone()
    before = ops.LAUNCHES["prox_sgd"]
    assert ops.prox_sgd_op(got, grad, anchor, steps, 4, 0.05, mu) is got
    ref.prox_sgd_masked_ref_(want, grad, anchor, steps, 4, 0.05, mu)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["prox_sgd"] == before + 1
    _close(got, want, TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(got, want)
    masked = steps <= 4
    assert torch.equal(got[masked], w[masked])         # bitwise no-op


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("c,p", [(3, 4099), (10, P_MLP)])
def test_sim_kernels_take_inputs_off_16_bytes(dev, c, p, dtype, shift):
    """Every input a view whose base pointer is not on 16 bytes (prox_sgd
    goes element by element): f32 bitwise the plain ops, bf16 within
    2e-2, masked rows untouched."""
    g = torch.Generator(device=dev).manual_seed(shift + c)
    w, grad, x = (_misaligned(dev, (c, p), dtype, shift, g)
                  for _ in range(3))
    anchor, base = (_misaligned(dev, (p,), dtype, shift, g)
                    for _ in range(2))
    steps = torch.tensor([5 if i % 3 else 2 for i in range(c)],
                         dtype=torch.int32, device=dev)
    before, want = w.clone(), w.clone()
    ops.prox_sgd_op(w, grad, anchor, steps, 4, 0.05, 0.1)
    ref.prox_sgd_masked_ref_(want, grad, anchor, steps, 4, 0.05, 0.1)
    wk = torch.rand((c,), generator=g, device=dev)
    agg = ops.fedagg_op(x, wk, base, 0.5)
    torch.cuda.synchronize()
    masked = steps <= 4
    assert torch.equal(w[masked], before[masked])
    _close(w, want, TOL[dtype])
    _close(agg, ref.fedagg_ref(x, wk, base, 0.5), TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(w, want)
        assert torch.equal(agg, _ordered_fedagg(x, wk, base, 0.5))


# The batched sweep's forms. (R, P, rows of w0): the smoke's 32 x 10
# stack with one anchor per scenario or per client, one scenario (S = 1),
# rows not a multiple of 4, and narrow widths where every vector
# straddles rows (mu alternates row by row below, so a straddling vector's
# two rows have different mu).
ROWS_SHAPES = [(320, 47_887, 32), (320, 47_887, 320), (10, 47_887, 1),
               (7, 47_887, 7), (13, P_MLP, 1), (9, 5, 3), (6, 3, 2),
               (15, 4099, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,p,rows", ROWS_SHAPES)
def test_prox_sgd_rows_form_matches_plain(dev, r, p, rows, dtype):
    """Per-row mu (0 and 0.01 alternating) and grouped anchors: f32
    bitwise the plain version, bf16 within 2e-2, masked rows untouched,
    one launch."""
    g = torch.Generator(device=dev).manual_seed(r + p + rows)
    w = torch.randn((r, p), generator=g, device=dev).to(dtype)
    grad = torch.randn((r, p), generator=g, device=dev).to(dtype)
    anchor = torch.randn((rows, p), generator=g, device=dev).to(dtype)
    steps = torch.tensor([2 if i % 10 >= 7 else 8 for i in range(r)],
                         dtype=torch.int32, device=dev)
    mu = torch.tensor([0.01 * (i % 2) for i in range(r)], device=dev)
    got, want = w.clone(), w.clone()
    before = ops.LAUNCHES["prox_sgd"]
    assert ops.prox_sgd_op(got, grad, anchor, steps, 3, 0.05, mu) is got
    ref.prox_sgd_rows_ref_(want, grad, anchor, steps, 3, 0.05, mu)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["prox_sgd"] == before + 1
    _close(got, want, TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(got, want)
    masked = steps <= 3
    assert torch.equal(got[masked], w[masked])


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("s,k,p", [(32, 10, 47_887), (1, 10, 47_887),
                                   (5, 7, 4099), (3, 1, 3), (70, 3, 777)])
def test_fedagg_batched_form_matches_ordered_sum(dev, s, k, p, delta):
    """Each scenario bitwise the ordered f32 sum with its own scale; one
    scenario's weights all zero keeps its base (delta form) bit for bit;
    one launch."""
    g = torch.Generator(device=dev).manual_seed(s * k + p)
    x = torch.randn((s, k, p), generator=g, device=dev)
    w = torch.rand((s, k), generator=g, device=dev)
    w[s // 2] = 0.0
    base = torch.randn((s, p), generator=g, device=dev) if delta else None
    scale = torch.rand((s,), generator=g, device=dev) + 0.5
    before = ops.LAUNCHES["fedagg"]
    got = ops.fedagg_op(x, w, base, scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedagg"] == before + 1
    assert got.shape == (s, p)
    _close(got, ref.fedagg_batched_ref(x, w, base, scale), TOL[torch.float32])
    for i in range(s):
        assert torch.equal(got[i], _ordered_fedagg(
            x[i], w[i], None if base is None else base[i], scale[i]))
    if delta:
        assert torch.equal(got[s // 2], base[s // 2])


def test_batched_sweep_trains_through_one_launch_a_step(dev):
    """A small femnist_cnn batch on the card: one prox_sgd launch per
    local step (the round's largest budget) and one fedagg per round."""
    from repro_torch.sim import BatchedSweep
    from repro_torch.sim.engine import client_steps
    H = 2 * 86400.0
    cells = [("fedavg", 2, 2, 1), ("fedprox", 2, 5, 2), ("fedbuff", 2, 2, 1)]
    sims = [ConstellationSim(
        WalkerStar(cl, sp), station_subnetwork(g), ALGORITHMS[a],
        data=synth_femnist(cl * sp, seed=0),
        cfg=SimConfig(max_rounds=3, horizon_s=H, max_steps=16),
        access=compute_access_windows(WalkerStar(cl, sp),
                                      station_subnetwork(g), horizon_s=H,
                                      device=dev),
        workload="femnist_cnn", device=dev) for a, cl, sp, g in cells]
    ops.reset_launches()
    res = BatchedSweep(sims).run()
    torch.cuda.synchronize()
    rounds = max(len(r.rounds) for r in res)
    steps = sum(max(client_steps(int(sim.data.n[k]), e, 32, 16)
                    for r, sim in zip(res, sims) if i < len(r.rounds)
                    for k, e in zip(r.rounds[i].participants,
                                    r.rounds[i].epochs))
                for i in range(rounds))
    assert ops.LAUNCHES["fedagg"] == rounds > 0
    assert ops.LAUNCHES["prox_sgd"] == steps
    assert all(r.final_params is not None for r in res)


def test_prox_sgd_unaligned_rows_take_the_scalar_path(dev):
    """A view that starts off a 16-byte boundary is still updated right."""
    g = torch.Generator(device=dev).manual_seed(1)
    buf = torch.randn((2 * 1000 + 1,), generator=g, device=dev)
    w = buf[1:].view(2, 1000)              # P % 4 == 0, pointer 4 B off
    grad = torch.randn((2, 1000), generator=g, device=dev)
    want = ref.prox_sgd_ref(w, grad, torch.zeros_like(w), 0.05, 0.0)
    ops.prox_sgd_op(w, grad, torch.zeros_like(w),
                    torch.ones((2,), dtype=torch.int32, device=dev), 0,
                    0.05, 0.0)
    torch.cuda.synchronize()
    _close(w, want, 2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 8), device=dev)
    w = torch.ones((4,), device=dev)
    with pytest.raises(TypeError):
        ops.fedagg_op(x.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fedagg_op(x.t(), torch.ones((8,), device=dev))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fedagg_op(x, w.cpu())
    steps = torch.ones((4,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        ops.prox_sgd_op(x, x, x, steps.long(), 0, 0.05, 0.0)
    with pytest.raises(ValueError, match="w0"):
        ops.prox_sgd_op(x, x, x[:, :4].contiguous(), steps, 0, 0.05, 0.0)


def test_card_visibility_differs_from_cpu_only_at_mask_ties(dev):
    """The f32 grid on the card flips only samples whose elevation lies
    within 1e-3 degrees of the mask (sin/cos round differently there)."""
    cst, st = WalkerStar(3, 3), station_subnetwork(3)
    el, (lat, lon) = cst.elements(), station_latlon(st)
    t = torch.arange(0, 2 * 86400.0 + 1, 30.0, dtype=torch.float64).float()
    cpu = visibility_grid(el, lat, lon, t)
    card = visibility_grid(el, lat, lon, t.to(dev)).cpu()
    elev = elevation_deg(eci_positions(el, t), gs_eci_positions(lat, lon, t))
    diff = cpu != card
    assert bool((elev[diff] - 10.0).abs().le(1e-3).all()), \
        elev[diff].tolist()


def test_card_run_matches_cpu_run(dev):
    """fedprox on c2s2/g1: the card and the CPU give the same RoundRecords
    and final params within 1e-4 (f32 sums in another order), from one
    set of access windows, init params and minibatch draws."""
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    horizon = 4 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    data = synth_femnist(cst.n_sats, seed=0)
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16)
    runs = {}
    for device in ("cpu", dev):
        cpu_draws = TorchSampler(0, "cpu")

        class OnDevice:
            def init(self, workload, _d=device):
                return cpu_draws.init(workload).to(_d)

            def minibatches(self, n_valid, bound, batch_size, _d=device):
                return cpu_draws.minibatches(n_valid, bound,
                                             batch_size).to(_d)

        before = dict(ops.LAUNCHES)
        runs[str(device)] = ConstellationSim(
            cst, st, ALGORITHMS["fedprox"], data=data, cfg=cfg, access=aw,
            device=device, sampler=OnDevice()).run()
        moved = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        if device == dev:
            assert moved["fedagg"] > 0 and moved["prox_sgd"] > 0, moved
        else:
            assert not any(moved.values()), moved
    cpu, card = runs["cpu"], runs[str(dev)]
    fields = ("t_start", "t_end", "participants", "epochs", "idle_s",
              "compute_s", "comm_s", "relays", "staleness")
    assert [[getattr(r, f) for f in fields] for r in card.rounds] == \
        [[getattr(r, f) for f in fields] for r in cpu.rounds]
    for layer in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            torch.testing.assert_close(
                torch.as_tensor(card.final_params[layer][leaf]),
                torch.as_tensor(cpu.final_params[layer][leaf]),
                rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ comms
# Threshold-tie band of the ISL distance tests (tests/test_torch_comms.py).
ISL_TIE_M = 50.0


def test_card_isl_windows_differ_from_cpu_only_at_threshold_ties(dev):
    """c10s10 with cross-plane links and 2 seam candidates over 1 day: the
    card's f32 ISL grid flips only samples whose blocking radius or range
    lies within ISL_TIE_M of its threshold."""
    cst = WalkerStar(10, 10)
    el = cst.elements()
    topo = isl.ISLTopology.walker_grid(cst, cross_plane=True, seam_k=2)
    ei = torch.tensor([i for i, _ in topo.edges])
    ej = torch.tensor([j for _, j in topo.edges])
    t = torch.arange(0, 86400.0 + 1, 30.0, dtype=torch.float64).float()
    reach = isl.DEFAULT_ISL_MAX_RANGE_KM * 1e3
    cpu = isl.isl_visibility_grid(el, ei, ej, t, reach)
    card = isl.isl_visibility_grid(el, ei.to(dev), ej.to(dev), t.to(dev),
                                   reach).cpu()
    min_r, rng = isl.isl_margins(el, ei, ej, t)
    diff = cpu != card
    tie = (((min_r - (isl.R_EARTH + isl.ATMOSPHERE_PAD_M)).abs()
            <= ISL_TIE_M) | ((rng - reach).abs() <= ISL_TIE_M))
    assert bool(tie[diff].all()), int((diff & ~tie).sum())
    if not diff.any():
        a = isl.compute_isl_windows(cst, topo, horizon_s=86400.0,
                                    device="cpu")
        b = isl.compute_isl_windows(cst, topo, horizon_s=86400.0, device=dev)
        assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for pa, pb in zip(a.per_edge, b.per_edge)
                   for x, y in zip(pa, pb))


@pytest.mark.parametrize("name", ["quant_int8", "quant_fp8", "topk_sparse"])
def test_card_codec_roundtrip_matches_cpu(dev, name):
    """One codec round trip of a 10-client femnist_mlp stack on the card
    and on the CPU from the same params, anchors and uniforms: bitwise
    (exactly rounded f32 division, floor, compare and product on both),
    but for quant_fp8 elements where `log2` of the normalized magnitude
    lies within an ulp of an integer (one quantization step apart)."""
    from repro_torch.comms.codec import CODECS, client_roundtrip
    from repro_torch.params import FEMNIST_MLP
    g = torch.Generator().manual_seed(3)
    params = torch.randn((10, P_MLP), generator=g) * 0.1
    anchor = params + torch.randn((10, P_MLP), generator=g) * 1e-3
    u = torch.rand((10, P_MLP), generator=g)
    codec = CODECS[name]
    cpu = client_roundtrip(codec, params, anchor, FEMNIST_MLP, u)
    card = client_roundtrip(codec, params.to(dev), anchor.to(dev),
                            FEMNIST_MLP, u.to(dev)).cpu()
    diff = cpu != card
    if name != "quant_fp8":
        assert not diff.any(), int(diff.sum())
        return
    segs = torch.split(params - anchor, FEMNIST_MLP.sizes, dim=-1)
    v = torch.cat([x / x.abs().amax(-1, keepdim=True) for x in segs], -1)
    lg = torch.log2(v.abs().clamp(min=2.0 ** -30))
    near = (lg - lg.round()).abs() <= torch.finfo(torch.float32).eps * \
        lg.abs().clamp(min=1.0)
    assert bool(near[diff].all()), int((diff & ~near).sum())


# ------------------------------------------------------------ LM kernels
# (rtol, atol). In bf16 both sides round one f32 result, so they differ
# by at most one bf16 step: 2**-7 * |want| < 8e-3 * |want|.
FLASH_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (8e-3, 1e-3)}
FLASH_CASES = [
    # (B, H, KV, S, D, causal, window, softcap)
    (4, 25, 5, 2048, 64, True, 1024, None),    # hymba-1.5b serving, SWA
    (4, 25, 5, 2048, 64, True, None, None),    # hymba-1.5b anchor layers
    (1, 2, 2, 128, 64, True, None, None),      # test_kernels.py's masks:
    (2, 4, 2, 128, 64, True, None, None),      # (GQA; D 32 there)
    (1, 4, 1, 256, 64, True, 64, None),
    (1, 2, 2, 128, 64, False, None, None),
    (1, 2, 2, 128, 64, True, None, 30.0),
    (1, 2, 1, 64, 128, True, 16, None),
    (2, 4, 2, 1000, 64, True, 100, None),      # S not a tile multiple
    (1, 8, 1, 300, 256, True, None, None),     # D = 256 with MQA
    (1, 4, 4, 33, 128, False, 8, 50.0),        # bidirectional window
]


def _flash_inputs(dev, b, h, kv, s, d, dtype):
    g = torch.Generator(device=dev).manual_seed(b * h * s + d)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window,softcap", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, b, h, kv, s, d, causal,
                                              window, softcap, dtype):
    q, k, v = _flash_inputs(dev, b, h, kv, s, d, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.flash_attention_ref(q, k, v, **kw), *FLASH_TOL[dtype])


def test_flash_attention_reads_the_model_layout_in_place(dev):
    """(B, S, H, D) tensors go in as transposed views; the output keeps
    q's layout, so the model's reshape to (B, S, H * D) is a view."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _flash_inputs(dev, 2, 25, 5, 200, 64, torch.bfloat16))
    assert not q.is_contiguous()
    got = ops.flash_attention_op(q, k, v, window=64)
    assert got.stride() == q.stride()
    want = ops.flash_attention_op(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The bf16 kernel (tensor cores): every head dim on S below, at, past and
# far past one 64-row tile, with windows smaller than, equal to and larger
# than a tile. rep cycles with D so each head dim sees GQA.
@pytest.mark.parametrize("d,rep", [(64, 5), (128, 8), (256, 1)])
@pytest.mark.parametrize("s", [1, 63, 65, 1000, 2048])
@pytest.mark.parametrize("window", [16, 64, 1024, None])
def test_flash_attention_bf16_sweep_matches_plain(dev, d, rep, s, window):
    q, k, v = _flash_inputs(dev, 1, 2 * rep, 2, s, d, torch.bfloat16)
    got = ops.flash_attention_op(q, k, v, window=window)
    torch.cuda.synchronize()
    _close(got, ref.flash_attention_ref(q, k, v, window=window),
           *FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("rep", [1, 5, 8])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, 30.0), (True, 100, 50.0), (False, None, 30.0),
    (False, 64, None)])
def test_flash_attention_bf16_masks_and_softcap_match_plain(
        dev, rep, causal, window, softcap):
    q, k, v = _flash_inputs(dev, 2, 2 * rep, 2, 300, 64, torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, ref.flash_attention_ref(q, k, v, **kw),
           *FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bf16_model_views_match_plain(dev, d):
    """The model's (B, S, H, D) tensors as (B, H, S, D) views, and a view
    whose rows do not start on 16 bytes (the wrapper copies it)."""
    B, S, H, KV = 2, 333, 10, 2
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn((B, S, H, d), generator=g, device=dev).bfloat16()
    kv = torch.randn((B, S, 2 * KV * d + 1), generator=g,
                     device=dev).bfloat16()
    k = kv[..., 1:1 + KV * d].unflatten(-1, (KV, d))
    v = kv[..., 1 + KV * d:].unflatten(-1, (KV, d))
    for kk, vv in ((k.contiguous(), v.contiguous()), (k, v)):
        args = (q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2))
        got = ops.flash_attention_op(*args, window=128)
        torch.cuda.synchronize()
        _close(got, ref.flash_attention_ref(*args, window=128),
               *FLASH_TOL[torch.bfloat16])


def _wkv6_inputs(dev, B, H, T, K, V, decay=0.3):
    g = torch.Generator(device=dev).manual_seed(B * H * T + K)
    r = torch.randn((B, H, T, K), generator=g, device=dev)
    k = torch.randn((B, H, T, K), generator=g, device=dev)
    v = torch.randn((B, H, T, V), generator=g, device=dev)
    lw = -torch.randn((B, H, T, K), generator=g, device=dev).abs() * decay
    s0 = torch.randn((B, H, K, V), generator=g, device=dev)
    return r, k, v, lw, s0


@pytest.mark.parametrize("B,H,T,K,V,chunk", [
    (4, 50, 2048, 16, 64, 64),      # hymba-1.5b serving (SSD heads)
    (2, 4, 256, 64, 64, 64),        # K = V = 64 (RWKV6 heads)
    (2, 3, 96, 16, 32, 32),         # test_kernels.py's sweep shapes
    (2, 3, 64, 64, 64, 16),
    (2, 3, 100, 16, 64, 64),        # T not a chunk multiple
    (1, 2, 20, 16, 64, 64),         # T shorter than one chunk
])
def test_wkv6_kernel_matches_plain(dev, B, H, T, K, V, chunk):
    args = _wkv6_inputs(dev, B, H, T, K, V)
    before = ops.LAUNCHES["wkv6"]
    o, s = ops.wkv6_op(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6"] == before + 1
    wo, ws = ref.wkv6_ref(*args, chunk=chunk)
    _close(o, wo, 2e-4)
    _close(s, ws, 2e-4)


def test_wkv6_kernel_strong_decay_stays_finite(dev):
    r, k, v, _, _ = _wkv6_inputs(dev, 1, 1, 256, 32, 32)
    lw = torch.full_like(r, -5.0)                # near-total per-step decay
    s0 = torch.zeros((1, 1, 32, 32), device=dev)
    o, s = ops.wkv6_op(r, k, v, lw, s0, chunk=128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    wo, ws = ref.wkv6_ref(r, k, v, lw, s0, chunk=128)
    _close(o, wo, 2e-4)
    _close(s, ws, 2e-4)


def test_wkv6_kernel_reads_broadcast_views(dev):
    """The SSD heads pass k broadcast over heads and logw over the state
    dim (stride 0), and v as a transposed view: read where they lie."""
    B, H, T, N, hd = 2, 6, 130, 16, 64
    g = torch.Generator(device=dev).manual_seed(7)
    r = torch.randn((B, H, T, N), generator=g, device=dev)
    k = torch.randn((B, 1, T, N), generator=g, device=dev).expand(B, H, T, N)
    lw = -torch.rand((B, H, T, 1), generator=g, device=dev).expand(
        B, H, T, N)
    v = torch.randn((B, T, H, hd), generator=g, device=dev).transpose(1, 2)
    s0 = torch.zeros((B, H, N, hd), device=dev)
    o, s = ops.wkv6_op(r, k, v, lw, s0)
    assert o.stride() == v.stride()
    wo, ws = ops.wkv6_op(r, k.contiguous(), v.contiguous(), lw.contiguous(),
                         s0)
    torch.cuda.synchronize()
    assert torch.equal(o, wo) and torch.equal(s, ws)


# Chunk-parallel wkv6: T below, at and past one chunk and at the serving
# length, one (b, h), K = V = 64 (chunk 128 at K = V = 32: (64, 64, 128)
# needs more shared memory than a block has).
@pytest.mark.parametrize("T", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("chunk,K", [(16, 64), (64, 64), (128, 32)])
def test_wkv6_kernel_sweep_matches_plain(dev, T, chunk, K):
    args = _wkv6_inputs(dev, 1, 1, T, K, K)
    o, s = ops.wkv6_op(*args, chunk=chunk)
    torch.cuda.synchronize()
    wo, ws = ref.wkv6_ref(*args, chunk=chunk)
    _close(o, wo, 2e-4)
    _close(s, ws, 2e-4)


@pytest.mark.parametrize("T", [1, 65, 2048])
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_wkv6_kernel_broadcast_views_match_plain(dev, T, chunk):
    """The SSD heads' layout (k stride 0 over heads, logw stride 0 over
    the state dim, v transposed) against the plain version."""
    B, H, N, hd = 2, 3, 16, 64
    g = torch.Generator(device=dev).manual_seed(T + chunk)
    r = torch.randn((B, H, T, N), generator=g, device=dev)
    k = torch.randn((B, 1, T, N), generator=g, device=dev).expand(B, H, T, N)
    lw = -torch.rand((B, H, T, 1), generator=g, device=dev).expand(
        B, H, T, N)
    v = torch.randn((B, T, H, hd), generator=g, device=dev).transpose(1, 2)
    s0 = torch.randn((B, H, N, hd), generator=g, device=dev)
    o, s = ops.wkv6_op(r, k, v, lw, s0, chunk=chunk)
    torch.cuda.synchronize()
    wo, ws = ref.wkv6_ref(r, k, v, lw, s0, chunk=chunk)
    _close(o, wo, 2e-4)
    _close(s, ws, 2e-4)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_wkv6_kernel_strong_decay_matches_plain_at_every_chunk(dev, chunk):
    r, k, v, _, s0 = _wkv6_inputs(dev, 1, 2, 300, 32, 32)
    lw = torch.full_like(r, -8.0)
    o, s = ops.wkv6_op(r, k, v, lw, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    wo, ws = ref.wkv6_ref(r, k, v, lw, s0, chunk=chunk)
    _close(o, wo, 2e-4)
    _close(s, ws, 2e-4)


def test_wkv6_wrapper_rejects_a_chunk_past_shared_memory(dev):
    with pytest.raises(ValueError, match="shared memory"):
        ops.wkv6_op(*_wkv6_inputs(dev, 1, 1, 8, 64, 64), chunk=128)


def test_cuda_tensors_never_take_the_plain_versions(dev, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("flash_attention_ref", "wkv6_ref", "fedagg_ref",
                 "prox_sgd_masked_ref_"):
        monkeypatch.setattr(ref, name, refuse)
    q, k, v = _flash_inputs(dev, 1, 2, 1, 64, 64, torch.float32)
    ops.flash_attention_op(q, k, v)
    ops.wkv6_op(*_wkv6_inputs(dev, 1, 2, 64, 16, 64))
    x = torch.ones((3, 100), device=dev)
    ops.fedagg_op(x, torch.ones((3,), device=dev))
    ops.prox_sgd_op(x, x, x[0], torch.ones((3,), dtype=torch.int32,
                                           device=dev), 0, 0.1, 0.0)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention_op(q, k.cpu(), v)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6_op(*(t.double() for t in _wkv6_inputs(dev, 1, 1, 8, 16,
                                                         64)))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma-2b"])
def test_reduced_lm_card_matches_cpu(dev, arch):
    """Reduced hymba-1.5b / gemma-2b (f32) from one set of weights on the
    card and on the CPU, with a 160-token prompt (the 128-token window's
    ring cache rolls): identical greedy tokens over 8 decode steps, logits
    within 1e-4 (f32 sums in another order)."""
    cfg = get_config(arch).reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 160),
                            generator=torch.Generator().manual_seed(1))
    out = {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        before = dict(ops.LAUNCHES)
        toks, _, logits = serve.serve_batch(
            cfg, params, prompts.to(params["embed"].device), 8)
        moved = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        out[where] = (toks.cpu(), logits.cpu(), moved)
    assert torch.equal(out["card"][0], out["cpu"][0])
    _close(out["card"][1], out["cpu"][1], 1e-4)
    assert not any(out["cpu"][2].values())
    assert out["card"][2]["flash_attention"] == cfg.n_layers
    assert out["card"][2]["wkv6"] == (cfg.n_layers if arch == "hymba-1.5b"
                                      else 0)



# ------------------------------------------- LM training: backward kernels
# The backward kernels against their plain backward (`ref.*_bwd_ref`, the
# kernels' formulas in torch) on the same card inputs: f32 within 2e-5,
# bf16 as the forward (FLASH_TOL: both sides round one f32 result, one
# bf16 step apart at most). dlogw, a suffix sum over the whole sequence of
# terms that cancel, is held to 2e-5 of the terms' scale (max |r dr| +
# max |k dk|) besides its relative part.
BWD_TOL = {torch.float32: (2e-5, 2e-5),
           torch.bfloat16: FLASH_TOL[torch.bfloat16]}
BWD_FLASH_CASES = [
    # b, h, kv, s, d, dtype, causal, window, softcap
    (64, 2, 2, 33, 32, torch.float32, True, None, None),    # lm_tiny
    (64, 4, 4, 33, 64, torch.float32, True, 128, None),     # lm_hybrid_tiny
    (2, 4, 2, 100, 64, torch.float32, True, 16, None),
    (1, 2, 2, 70, 32, torch.float32, False, None, 30.0),
    (1, 4, 1, 64, 128, torch.float32, True, None, None),
    (1, 2, 1, 40, 256, torch.float32, True, None, 5.0),
    (2, 25, 5, 2048, 64, torch.bfloat16, True, 1024, None),  # hymba-1.5b
    (2, 25, 5, 2048, 64, torch.bfloat16, True, None, None),
    # The bf16 tensor-core kernels' tiles: D = 128 and 256, softcap,
    # non-causal, S not a multiple of 64, rep = 1.
    (1, 8, 2, 1024, 128, torch.bfloat16, True, 512, None),
    (1, 8, 1, 300, 256, torch.bfloat16, True, None, None),
    (1, 4, 2, 256, 64, torch.bfloat16, True, None, 30.0),
    (1, 2, 2, 200, 64, torch.bfloat16, False, None, None),
    (2, 4, 2, 1000, 64, torch.bfloat16, True, 100, None),
    (1, 4, 4, 333, 64, torch.bfloat16, True, 128, None),
    (1, 4, 4, 33, 128, torch.bfloat16, False, 8, 50.0),
]


@pytest.mark.parametrize("b,h,kv,s,d,dtype,causal,window,softcap",
                         BWD_FLASH_CASES)
def test_flash_attention_bwd_kernel_matches_plain(dev, b, h, kv, s, d, dtype,
                                                  causal, window, softcap):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = _flash_inputs(dev, b, h, kv, s, d, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    do = torch.randn(o.shape, generator=torch.Generator(device=dev)
                     .manual_seed(s), device=dev).to(dtype)
    got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    for a, b_, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b_)         # no atomics: the same bits
        _close(a, w, *BWD_TOL[dtype])


def test_flash_attention_op_backward_launches_the_kernel(dev):
    """The op's backward on CUDA tensors is one `flash_attention_bwd`
    launch, on the model's transposed (B, S, H, D) views."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               .requires_grad_(True)
               for t in _flash_inputs(dev, 4, 2, 2, 33, 32, torch.float32))
    before = dict(ops.LAUNCHES)
    o = ops.flash_attention_op(q, k, v)
    g = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       o.detach(), g)
    for a, w in zip(got, want):
        _close(a, w, TOL[torch.float32])


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bwd_reads_the_model_views(dev, d):
    """bf16 through the op on the model's transposed (B, S, H, D) views:
    one launch each way, the saved lse, gradients in the views' layout
    within the bf16 tolerance of the plain backward, the same bits
    twice."""
    b, s, h, kv = 2, 200, 8, 2
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev)
               .to(torch.bfloat16).transpose(1, 2).requires_grad_(True)
               for n in (h, kv, kv))
    do = torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        before = dict(ops.LAUNCHES)
        o = ops.flash_attention_op(q, k, v, window=64)
        grads.append(torch.autograd.grad(o, (q, k, v), do))
        assert ops.LAUNCHES["flash_attention_bwd"] == \
            before["flash_attention_bwd"] + 1
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       o.detach(), do, window=64)
    for a, b_, w, x in zip(*grads, want, (q, k, v)):
        assert a.stride() == x.stride() and torch.equal(a, b_)
        _close(a, w, *BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op_saved_lse_matches_recomputed(dev, dtype):
    """The op's backward reads the kernel forward's lse; the backward
    kernel given lse recomputed by the plain forward agrees within the
    tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    leaves = [t.requires_grad_(True)
              for t in _flash_inputs(dev, 2, 4, 2, 300, 64, dtype)]
    o = ops.flash_attention_op(*leaves, window=100)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, leaves, do)
    q, k, v = (t.detach() for t in leaves)
    lse = ref.flash_attention_ref(q, k, v, window=100, return_lse=True)[1]
    want = flash_attention_bwd(q, k, v, o.detach(), do, lse, window=100)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        _close(a, w, *BWD_TOL[dtype])


def test_flash_attention_head_dim_32(dev):
    """D = 32 (lm_tiny) runs the f32 kernel; bf16 refuses it by name."""
    q, k, v = _flash_inputs(dev, 64, 2, 2, 33, 32, torch.float32)
    got = ops.flash_attention_op(q, k, v)
    _close(got, ref.flash_attention_ref(q, k, v), *FLASH_TOL[torch.float32])
    with pytest.raises(ValueError, match="head dim 32"):
        ops.flash_attention_op(*(t.bfloat16() for t in (q, k, v)))


BWD_WKV6_CASES = [
    # b, h, t, k, v, decay, SSD views, end-state gradient
    (128, 8, 33, 16, 64, "ssd", True, False),      # lm_hybrid_tiny
    (2, 50, 2048, 16, 64, "ssd", True, False),     # hymba-1.5b
    (2, 3, 100, 16, 64, "strong", False, True),
    (1, 2, 200, 32, 32, "mixed", False, True),
    (1, 32, 2048, 64, 64, "mixed", False, True),   # rwkv6: K = V = 64
    (2, 4, 1000, 16, 64, "ssd", True, True),       # 16 chunks, ragged tail
]


@pytest.mark.parametrize("b,h,t,k,v,decay,views,end_grad", BWD_WKV6_CASES)
def test_wkv6_bwd_kernel_matches_plain(dev, b, h, t, k, v, decay, views,
                                       end_grad):
    from repro_torch.kernels.wkv6 import wkv6_bwd
    g = torch.Generator(device=dev).manual_seed(b * t + k)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    r = rnd(b, h, t, k)
    if views:
        kk = rnd(b, 1, t, k).expand(b, h, t, k)
        vv = rnd(b, t, h, v).transpose(1, 2)
        lw = -0.3 * rnd(b, h, t, 1).abs().expand(b, h, t, k)
    else:
        kk, vv = rnd(b, h, t, k), rnd(b, h, t, v)
        lw = torch.full((b, h, t, k), -5.0, device=dev) \
            if decay == "strong" else -0.3 * rnd(b, h, t, k).abs()
    s0, do = rnd(b, h, k, v), rnd(b, h, t, v)
    ds = rnd(b, h, k, v) if end_grad else None
    states = ref.wkv6_ref(r, kk, vv, lw, s0, return_states=True)[2]
    got = wkv6_bwd(r, kk, vv, lw, s0, do, ds, states)
    again = wkv6_bwd(r, kk, vv, lw, s0, do, ds, states)
    want = ref.wkv6_bwd_ref(r, kk, vv, lw, s0, do, ds, 64, states)
    torch.cuda.synchronize()
    terms = float((r * want[0]).abs().max() + (kk * want[1]).abs().max())
    for i, (a, b_, w) in enumerate(zip(got, again, want)):
        assert a.shape == w.shape and torch.equal(a, b_)
        _close(a, w, 2e-5, 2e-5 * terms if i == 3 else 2e-5)


def test_wkv6_op_backward_launches_the_kernel(dev):
    """Through the SSD heads' broadcast views: one `wkv6_bwd` launch, and
    autograd sums its dense gradients back over the expanded axes."""
    b, h, t, k, v = 4, 8, 33, 16, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    r = torch.randn((b, h, t, k), generator=gen, device=dev)
    kb = torch.randn((b, 1, t, k), generator=gen, device=dev)
    vv = torch.randn((b, t, h, v), generator=gen, device=dev)
    lwb = -0.3 * torch.randn((b, h, t, 1), generator=gen, device=dev).abs()
    leaves = [x.requires_grad_(True) for x in (r, kb, vv, lwb)]
    s0 = torch.zeros((b, h, k, v), device=dev)
    before = ops.LAUNCHES["wkv6_bwd"]
    o, _ = ops.wkv6_op(leaves[0], leaves[1].expand(b, h, t, k),
                       leaves[2].transpose(1, 2),
                       leaves[3].expand(b, h, t, k), s0)
    got = torch.autograd.grad(o, leaves, torch.ones_like(o))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6_bwd"] == before + 1
    dense = ref.wkv6_bwd_ref(r.detach(), kb.detach().expand(b, h, t, k),
                             vv.detach().transpose(1, 2),
                             lwb.detach().expand(b, h, t, k), s0,
                             torch.ones((b, h, t, v), device=dev))
    want = (dense[0], dense[1].sum(1, keepdim=True),
            dense[2].transpose(1, 2), dense[3].sum(-1, keepdim=True))
    for a, w in zip(got, want):
        assert a.shape == w.shape
        _close(a, w, 2e-5, 2e-5 * max(1.0, float(w.abs().max())))


def test_wkv6_op_saved_states_match_recomputed(dev):
    """The op's backward reads the kernel forward's chunk states; the
    plain backward recomputing them agrees within the tolerance."""
    b, h, t, k, v = 2, 4, 300, 16, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = [rnd(b, h, t, k), rnd(b, h, t, k), rnd(b, h, t, v),
         -0.3 * rnd(b, h, t, k).abs(), rnd(b, h, k, v)]
    leaves = [y.requires_grad_(True) for y in x]
    o, s_final = ops.wkv6_op(*leaves)
    do, ds = torch.randn_like(o), torch.randn_like(s_final)
    got = torch.autograd.grad((o, s_final), leaves, (do, ds))
    want = ref.wkv6_bwd_ref(*(y.detach() for y in x), do, ds)
    torch.cuda.synchronize()
    terms = float((x[0] * want[0]).abs().max() + (x[1] * want[1]).abs().max())
    for i, (a, w) in enumerate(zip(got, want)):
        _close(a, w, 2e-5, 2e-5 * terms if i == 3 else 2e-5)


def test_backward_wrappers_reject_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    q, k, v = _flash_inputs(dev, 1, 2, 1, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, q, torch.zeros((1, 2, 63),
                                                       device=dev))
    # bf16 takes the forward's head dims: D = 32 is f32 only.
    q, k, v = _flash_inputs(dev, 1, 2, 1, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 32"):
        flash_attention_bwd(q, k, v, q, q, torch.zeros((1, 2, 64),
                                                       device=dev))
    r, kk, vv, lw, s0 = _wkv6_inputs(dev, 1, 1, 100, 16, 64)
    states = ref.wkv6_ref(r, kk, vv, lw, s0, return_states=True)[2]
    with pytest.raises(ValueError, match="states"):
        wkv6_bwd(r, kk, vv, lw, s0, torch.zeros_like(vv), None, states[:0])
    r, kk, vv, lw, s0 = _wkv6_inputs(dev, 1, 1, 100, 18, 64)
    with pytest.raises(ValueError, match="multiples of 4"):
        wkv6_bwd(r, kk, vv, lw, s0, torch.zeros_like(vv), None, states)


# Each LM workload's (attention layers, scan layers).
LM_WORKLOAD_LAYERS = {"lm_tiny": (2, 0), "lm_hybrid_tiny": (2, 2),
                      "lm_rwkv6_tiny": (0, 2), "lm_moe_tiny": (4, 0)}


@pytest.mark.parametrize("workload", ["lm_tiny", "lm_hybrid_tiny",
                                      "lm_rwkv6_tiny", "lm_moe_tiny"])
def test_lm_workload_trains_on_the_card(dev, workload):
    """fedprox on c2s2/g1: one prox_sgd launch a local step, and one
    flash_attention (and wkv6) launch and backward a layer a local step
    for the whole client stack (rwkv6: wkv6 only; lm_moe_tiny's MLA at
    (D, Dv) = (96, 64))."""
    n_attn, n_scan = LM_WORKLOAD_LAYERS[workload]
    ops.reset_launches()
    res = ConstellationSim(
        WalkerStar(2, 2), station_subnetwork(1), ALGORITHMS["fedprox"],
        cfg=SimConfig(max_rounds=2, horizon_s=2 * 86400.0, max_steps=4),
        workload=workload, device=dev).run()
    torch.cuda.synchronize()
    steps = ops.LAUNCHES["prox_sgd"]
    assert res.n_rounds == 2 and steps > 0
    assert ops.LAUNCHES["flash_attention_bwd"] == n_attn * steps
    assert ops.LAUNCHES["wkv6_bwd"] == n_scan * steps
    assert all(math.isfinite(a) for *_, a in res.accuracy_curve)


# ------------------------------------------- rwkv6 time mix and the MoE
def _rwkv_views(dev, B, T, H, K, requires_grad=False):
    """r, k, v, logw as the time mix passes them: (B, T, H, K) tensors
    read as (B, H, T, K) transposed views; logw in the model's range
    (-exp of w0 around -6 .. -1)."""
    g = torch.Generator(device=dev).manual_seed(B * T + H)
    rnd = lambda: torch.randn((B, T, H, K), generator=g, device=dev)
    lw = -torch.exp(-6.0 + 5.0 * torch.rand((B, T, H, K), generator=g,
                                            device=dev))
    ts = [rnd(), rnd(), rnd(), lw]
    if requires_grad:
        ts = [t.requires_grad_(True) for t in ts]
    return ts, [t.transpose(1, 2) for t in ts]


@pytest.mark.parametrize("B,T,H", [(4, 2048, 32), (2, 33, 4), (1, 130, 2)])
def test_wkv6_rwkv6_views_match_plain(dev, B, T, H):
    """K = V = 64 on the time mix's transposed views, through the fixed
    build, the generic build and the plain version."""
    from repro_torch.kernels.wkv6 import wkv6
    _, (r, k, v, lw) = _rwkv_views(dev, B, T, H, 64)
    s0 = torch.zeros((B, H, 64, 64), device=dev)
    assert not r.is_contiguous()
    fixed = wkv6(r, k, v, lw, s0)
    generic = wkv6(r, k, v, lw, s0, generic=True)
    want = ref.wkv6_ref(r, k, v, lw, s0)
    torch.cuda.synchronize()
    for a, b, w in zip(fixed, generic, want):
        _close(a, w, 2e-4)
        _close(b, w, 2e-4)


def test_wkv6_bwd_rwkv6_views_match_plain(dev):
    """The time mix's gradient through `wkv6_op` at K = V = 64 on the
    transposed views: one `wkv6_bwd` launch, each input's gradient within
    the backward's tolerance of the plain backward."""
    B, T, H = 2, 300, 4
    leaves, (r, k, v, lw) = _rwkv_views(dev, B, T, H, 64, requires_grad=True)
    s0 = torch.zeros((B, H, 64, 64), device=dev)
    do = torch.randn((B, H, T, 64), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    before = ops.LAUNCHES["wkv6_bwd"]
    o, _ = ops.wkv6_op(r, k, v, lw, s0)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6_bwd"] == before + 1
    want = ref.wkv6_bwd_ref(*(t.detach() for t in (r, k, v, lw)), s0, do)
    terms = float((r * want[0]).abs().max() + (k * want[1]).abs().max())
    for i, (a, w) in enumerate(zip(got, want[:4])):
        assert a.shape == (B, T, H, 64)
        _close(a.transpose(1, 2), w, 2e-5, 2e-5 * terms if i == 3 else 2e-5)


@pytest.mark.parametrize("S,causal", [(2048, True), (300, True), (64, False)])
def test_flash_attention_bf16_d128_softcap_matches_plain(dev, S, causal):
    """grok-1's heads: bf16, D = 128, 48 query heads on 8 KV heads (cut
    to 16 on 8 below full length), logit softcap 30."""
    H = 48 if S == 2048 else 16
    q, k, v = _flash_inputs(dev, 1, H, 8, S, 128, torch.bfloat16)
    kw = dict(causal=causal, softcap=30.0)
    got = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, ref.flash_attention_ref(q, k, v, **kw),
           *FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("S,kind,n_shared", [(64, "gelu", 0), (8, "gelu", 0),
                                             (128, "swiglu", 1)])
def test_apply_moe_card_matches_cpu(dev, S, kind, n_shared):
    """Row-local (S >= 64) and global dispatch, at grok-1's capacity
    factor (tokens drop): the same slots on both, outputs and aux within
    1e-5."""
    import dataclasses
    from repro_torch.models.lm.moe import apply_moe, init_moe
    cfg = dataclasses.replace(get_config("grok-1-314b").reduced().moe,
                              capacity_factor=1.5, n_shared=n_shared)
    p = init_moe(torch.Generator().manual_seed(0), 256, cfg, kind,
                 device="cpu")
    x = torch.randn((3, S, 256), generator=torch.Generator().manual_seed(1))
    y, aux = apply_moe(p, x, cfg, kind)
    yc, auxc = apply_moe({k: (w.to(dev) if torch.is_tensor(w) else
                              {n: t.to(dev) for n, t in w.items()})
                          for k, w in p.items()}, x.to(dev), cfg, kind)
    torch.cuda.synchronize()
    _close(yc.cpu(), y, 1e-5)
    for name in aux:
        _close(auxc[name].cpu(), aux[name], 1e-5)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "grok-1-314b"])
def test_reduced_rwkv6_and_grok_card_match_cpu(dev, arch):
    """Reduced rwkv6-1.6b / grok-1 (f32) from one set of weights on the
    card and the CPU: a 130-token prompt, 8 greedy decode steps, identical
    tokens, logits within 1e-4; one `wkv6` (rwkv6) or `flash_attention`
    (grok-1) launch a layer per prefill; one training step's loss within
    1e-4 and each gradient leaf within 1e-4 of its largest element where
    that passes 1 (rwkv6's embedding gradient: its 0.02-scale rows are
    RMS-normed, so their gradient reaches ~8.5 and the card's f32 sums
    land up to 1.5e-4 from the CPU's there on an H100)."""
    from repro_torch.train.step import lm_loss
    cfg = get_config(arch).reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 130),
                            generator=torch.Generator().manual_seed(1))
    out = {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        before = dict(ops.LAUNCHES)
        toks, _, logits = serve.serve_batch(
            cfg, params, prompts.to(params["embed"].device), 8)
        moved = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        leaves = []
        from repro_torch.models.lm.params import map_tree
        map_tree(lambda t: leaves.append(t.requires_grad_(True)), params)
        loss, _ = lm_loss(cfg, params, {"tokens": prompts[:, :65].to(
            params["embed"].device)})
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        out[where] = (toks.cpu(), logits.cpu(), moved, float(loss), grads)
    assert torch.equal(out["card"][0], out["cpu"][0])
    _close(out["card"][1], out["cpu"][1], 1e-4)
    kernel = "wkv6" if arch == "rwkv6-1.6b" else "flash_attention"
    assert out["card"][2][kernel] == cfg.n_layers
    assert abs(out["card"][3] - out["cpu"][3]) <= 1e-4
    for a, b in zip(out["card"][4], out["cpu"][4]):
        _close(a, b, 1e-4, 1e-4 * max(1.0, float(b.abs().max())))


# ------------------------------------- MLA: value head dim Dv below D
MLA_FLASH_CASES = [
    # b, h, kv, s, d, dv, dtype, window, softcap
    (128, 4, 4, 33, 96, 64, torch.float32, None, None),      # lm_moe_tiny
    (2, 8, 2, 130, 96, 64, torch.float32, None, None),       # GQA, ragged S
    (1, 4, 4, 333, 192, 128, torch.float32, 100, None),
    (1, 16, 16, 2048, 192, 128, torch.bfloat16, None, None),  # deepseek-v3
    (2, 8, 2, 1000, 192, 128, torch.bfloat16, None, None),   # GQA, ragged S
    (1, 4, 2, 65, 192, 128, torch.bfloat16, 32, 30.0),
]


def _mla_inputs(dev, b, h, kv, s, d, dv, dtype):
    g = torch.Generator(device=dev).manual_seed(b * h * s + d + dv)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv))]


@pytest.mark.parametrize("b,h,kv,s,d,dv,dtype,window,softcap",
                         MLA_FLASH_CASES)
def test_flash_attention_dv_kernel_matches_plain(dev, b, h, kv, s, d, dv,
                                                 dtype, window, softcap):
    q, k, v = _mla_inputs(dev, b, h, kv, s, d, dv, dtype)
    kw = dict(window=window, softcap=softcap)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, s, dv)
    _close(got, ref.flash_attention_ref(q, k, v, **kw), *FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dv_reads_the_mla_views(dev, dtype):
    """MLA's (B, S, H, D) queries and keys (nope and rope dims
    concatenated) and (B, S, H, Dv) values as transposed views: the
    output's (B, S, H, Dv) layout is dense, so the model's reshape to
    (B, S, H * Dv) is a view."""
    B, S, H = 2, 200, 8
    g = torch.Generator(device=dev).manual_seed(7)
    q, k = (torch.randn((B, S, H, 192), generator=g, device=dev).to(dtype)
            .transpose(1, 2) for _ in range(2))
    v = torch.randn((B, S, H, 128), generator=g, device=dev).to(dtype) \
        .transpose(1, 2)
    got = ops.flash_attention_op(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (B, H, S, 128) and got.transpose(1, 2).is_contiguous()
    _close(got, ref.flash_attention_ref(q, k, v), *FLASH_TOL[dtype])


@pytest.mark.parametrize("b,h,kv,s,d,dv,window", [
    (128, 4, 4, 33, 96, 64, None),       # lm_moe_tiny's training step
    (2, 8, 2, 130, 96, 64, 50),
    (1, 4, 4, 256, 192, 128, None),
    (1, 4, 2, 100, 192, 128, None),
])
def test_flash_attention_bwd_f32_dv_matches_plain(dev, b, h, kv, s, d, dv,
                                                  window):
    """The f32 backward at (D, Dv) = (96, 64) and (192, 128) through the
    op: one launch, dq and dk of D columns and dv of Dv within 2e-5 of the
    plain backward, the same bits twice."""
    leaves = [t.requires_grad_(True) for t in
              _mla_inputs(dev, b, h, kv, s, d, dv, torch.float32)]
    do = torch.randn((b, h, s, dv), generator=torch.Generator(
        device=dev).manual_seed(s), device=dev)
    grads = []
    for _ in range(2):
        before = ops.LAUNCHES["flash_attention_bwd"]
        o = ops.flash_attention_op(*leaves, window=window)
        grads.append(torch.autograd.grad(o, leaves, do))
        assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(*(t.detach() for t in leaves),
                                       o.detach(), do, window=window)
    for a, b_, w in zip(*grads, want):
        assert a.shape == w.shape and torch.equal(a, b_)
        _close(a, w, *BWD_TOL[torch.float32])


def test_dv_pairs_the_kernels_do_not_take_raise(dev):
    """bf16 D = 96 (not whole 64-column wgmma blocks), the bf16 backward
    at Dv != D, and a pair no model uses: each raises by name."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = _mla_inputs(dev, 1, 2, 2, 64, 96, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        ops.flash_attention_op(q, k, v)
    q, k, v = _mla_inputs(dev, 1, 2, 2, 64, 192, 128, torch.bfloat16)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head dim 192 \\(values 128\\)"):
        flash_attention_bwd(q, k, v, o, o, lse)
    q, k, v = _mla_inputs(dev, 1, 2, 2, 64, 128, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim 128 \\(values 64\\)"):
        ops.flash_attention_op(q, k, v)


def test_reduced_deepseek_card_matches_cpu(dev):
    """lm_moe_tiny's model (deepseek-v3 reduced to 4 MLA layers, the last
    MoE, and the MTP head; f32) from one set of weights on the card and
    the CPU: a 130-token prompt, 8 absorbed decode steps, identical tokens,
    logits within 1e-4, one `flash_attention` launch a layer per prefill;
    one training step's loss within 1e-4 and each gradient leaf within
    1e-4 of its largest element where that passes 1, through one
    `flash_attention_bwd` launch a layer."""
    from repro_torch.models.lm.params import map_tree
    from repro_torch.train.step import lm_loss
    cfg = get_config("deepseek-v3-671b").reduced(n_layers=4, n_experts=8)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 130),
                            generator=torch.Generator().manual_seed(1))
    out = {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        before = dict(ops.LAUNCHES)
        toks, _, logits = serve.serve_batch(
            cfg, params, prompts.to(params["embed"].device), 8)
        leaves = []
        map_tree(lambda t: leaves.append(t.requires_grad_(True)), params)
        loss, _ = lm_loss(cfg, params, {"tokens": prompts[:, :65].to(
            params["embed"].device)})
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        moved = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        out[where] = (toks.cpu(), logits.cpu(), moved, float(loss), grads)
    assert torch.equal(out["card"][0], out["cpu"][0])
    _close(out["card"][1], out["cpu"][1], 1e-4)
    assert out["card"][2]["flash_attention"] == 2 * cfg.n_layers
    assert out["card"][2]["flash_attention_bwd"] == cfg.n_layers
    assert abs(out["card"][3] - out["cpu"][3]) <= 1e-4
    for a, b in zip(out["card"][4], out["cpu"][4]):
        _close(a, b, 1e-4, 1e-4 * max(1.0, float(b.abs().max())))


# ------------------------- cross-attention: keys of their own length
CROSS_CASES = [
    # b, h, kv, s, sk, d, dtype
    (4, 16, 16, 224, 1500, 64, torch.bfloat16),   # whisper serving
    (4, 16, 16, 448, 1500, 64, torch.bfloat16),   # whisper training
    (2, 8, 2, 1, 1500, 64, torch.bfloat16),       # one query
    (2, 4, 4, 100, 37, 64, torch.bfloat16),       # fewer keys than queries
    (1, 4, 2, 65, 64, 128, torch.bfloat16),
    (2, 4, 4, 33, 64, 64, torch.float32),         # reduced whisper
    (2, 4, 2, 100, 37, 64, torch.float32),
    (1, 2, 1, 7, 300, 32, torch.float32),
]


def _cross_inputs(dev, b, h, kv, s, sk, d, dtype):
    g = torch.Generator(device=dev).manual_seed(b * h * s + sk + d)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, h, s, d), (b, kv, sk, d), (b, kv, sk, d),
                          (b, h, s, d))]


@pytest.mark.parametrize("b,h,kv,s,sk,d,dtype", CROSS_CASES)
def test_flash_attention_cross_kernels_match_plain(dev, b, h, kv, s, sk, d,
                                                   dtype):
    """S queries against Sk keys, no mask: the forward (one launch, its
    lse) and the backward (dk and dv of Sk rows; the same bits twice)
    against their plain versions."""
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_bwd
    q, k, v, do = _cross_inputs(dev, b, h, kv, s, sk, d, dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=False)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    o, lse = ref.flash_attention_ref(q, k, v, causal=False, return_lse=True)
    _, got_lse = flash_attention(q, k, v, causal=False, return_lse=True)
    torch.cuda.synchronize()
    assert got.shape == (b, h, s, d)
    _close(got, o, *FLASH_TOL[dtype])
    _close(got_lse, lse, *FLASH_TOL[torch.float32])
    grads = flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=False, lse=lse)
    torch.cuda.synchronize()
    for a, b_, w in zip(grads, again, want):
        assert a.shape == w.shape and torch.equal(a, b_)
        _close(a, w, *BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_reads_the_model_views(dev, dtype):
    """Cross K/V as the model passes them: `enc_out @ wk` reshaped to (B,
    F, KV, hd) and transposed, against queries of another length, through
    the op forward and backward."""
    B, S, F, H = 2, 40, 150, 4
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, S, H, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, F, H * 64), generator=g, device=dev).to(dtype)
            .reshape(B, F, H, 64) for _ in range(2))
    leaves = [t.transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention_op(*leaves, causal=False)
    do = torch.randn(o.shape, generator=g, device=dev).to(dtype)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    want_o, lse = ref.flash_attention_ref(*leaves, causal=False,
                                          return_lse=True)
    _close(o, want_o, *FLASH_TOL[dtype])
    want = ref.flash_attention_bwd_ref(*(t.detach() for t in leaves),
                                       o.detach(), do, causal=False, lse=lse)
    for a, w in zip(got, want):
        _close(a, w, *BWD_TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, None), (False, 64)])
def test_flash_attention_cross_refuses_masks(dev, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_bwd
    q, k, v, do = _cross_inputs(dev, 1, 2, 2, 32, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="no causal or window mask"):
        flash_attention(q, k, v, causal=causal, window=window)
    lse = torch.zeros((1, 2, 32), device=dev)
    with pytest.raises(ValueError, match="no causal or window mask"):
        flash_attention_bwd(q, k, v, do, do, lse, causal=causal,
                            window=window)


def _stub_inputs(cfg, B: int, seed: int) -> dict:
    """Seeded random frame or prefix embeddings (on the CPU) for cfg."""
    g = torch.Generator().manual_seed(seed)
    if cfg.encoder is not None:
        return {"enc_embeds": torch.randn(
            (B, cfg.encoder.n_frames, cfg.d_model), generator=g)}
    return {"prefix_embeds": torch.randn(
        (B, cfg.n_prefix_tokens, cfg.d_model), generator=g)}


@pytest.mark.parametrize("arch,prompt_len", [("whisper-medium", 40),
                                             ("llava-next-mistral-7b", 130)])
def test_reduced_encdec_and_vlm_card_match_cpu(dev, arch, prompt_len):
    """Reduced whisper-medium (64 random frames) and llava (16 random
    prefix embeddings; 146 positions pass the 128-token window) from one
    set of weights on the card and the CPU: prefill and 8 greedy decode
    steps with identical tokens, logits within 1e-4; whisper's prefill
    3 `flash_attention` launches a layer (encoder, self, cross); one
    training step's loss within 1e-4 and each gradient leaf within 1e-4
    of its largest element where that passes 1."""
    from repro_torch.models.lm.params import map_tree
    from repro_torch.models.lm.transformer import init_decode_cache
    from repro_torch.train.step import lm_loss, make_serve_step
    cfg = get_config(arch).reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = lm_params_from_jax(lm_params_to_numpy(cpu_params), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    stub = _stub_inputs(cfg, 2, 2)
    out = {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        at = params["embed"].device
        extra = {k: t.to(at) for k, t in stub.items()}
        before = dict(ops.LAUNCHES)
        with torch.inference_mode():
            logits, cache = init_decode_cache(
                cfg, params, 2, prompt_len + 16 + 16, prompt=prompts.to(at),
                **extra)
            moved = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
            step = make_serve_step(cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            toks, all_logits = [tok], [logits]
            for _ in range(8):
                tok, logits, cache = step(params, tok, cache)
                toks.append(tok)
                all_logits.append(logits)
        leaves = []
        map_tree(lambda t: leaves.append(t.requires_grad_(True)), params)
        loss, _ = lm_loss(cfg, params, {"tokens": prompts[:, :33].to(at),
                                        **extra})
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        out[where] = (torch.cat(toks, 1).cpu(), torch.stack(all_logits).cpu(),
                      moved, float(loss), grads)
    assert torch.equal(out["card"][0], out["cpu"][0])
    _close(out["card"][1], out["cpu"][1], 1e-4)
    enc_layers = cfg.encoder.n_layers if cfg.encoder is not None else 0
    assert out["card"][2]["flash_attention"] == enc_layers + cfg.n_layers * (
        2 if enc_layers else 1)
    assert abs(out["card"][3] - out["cpu"][3]) <= 1e-4
    for a, b in zip(out["card"][4], out["cpu"][4]):
        _close(a, b, 1e-4, 1e-4 * max(1.0, float(b.abs().max())))


# ------------------------------------------------------------- the mesh
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,p", SIM_SHAPES + [(1, 4099), (5, 12345)])
def test_fedagg_partial_form_matches_plain(dev, k, p, dtype):
    """The partial form (a mesh rank's weighted deltas, no base added):
    f32 bitwise the ordered sum, bf16 within 2e-2 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(k * p + 1)
    x = torch.randn((k, p), generator=g, device=dev).to(dtype)
    w = torch.rand((k,), generator=g, device=dev)
    base = torch.randn((p,), generator=g, device=dev).to(dtype)
    before = ops.LAUNCHES["fedagg"]
    got = ops.fedagg_op(x, w, base, partial=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedagg"] == before + 1
    assert got.dtype == dtype and got.shape == (p,)
    _close(got, ref.fedagg_ref(x, w, base, partial=True), TOL[dtype])
    if dtype == torch.float32:
        xf, b = x.float(), base.float()
        acc = torch.zeros(p, device=dev)
        for i in range(k):
            acc = acc + w[i] * (xf[i] - b)
        assert torch.equal(got, acc)


def test_mesh_run_on_nccl_matches_host_run(dev, monkeypatch):
    """fedprox and fedbuff on c2s2/g1 through `execution="mesh"` on the
    card: a one-rank group whose CUDA backend is NCCL, one fedagg launch
    and two all-reduces a round, records and every round's params equal
    to the card's host run bit for bit (one rank rounds as the host
    path); a CUDA tensor on a group without NCCL is refused."""
    import torch.distributed as dist

    from repro_torch.sharding import COLLECTIVES, all_reduce_sum, \
        default_group, reset_collectives
    from repro_torch.sharding.compat import backend_for
    cst, st = WalkerStar(2, 2), station_subnetwork(1)
    horizon = 4 * 86400.0
    aw = compute_access_windows(cst, st, horizon_s=horizon, device="cpu")
    data = synth_femnist(cst.n_sats, seed=0)
    cfg = SimConfig(max_rounds=3, horizon_s=horizon, eval_every=1,
                    max_steps=16, record_params=True)
    group = default_group(dev)
    assert backend_for(torch.zeros(1, device=dev), group) == "nccl"
    for name in ("fedprox", "fedbuff"):
        runs = {}
        for mode in ("host", "mesh"):
            reset_collectives()
            before = dict(ops.LAUNCHES)
            runs[mode] = ConstellationSim(
                cst, st, ALGORITHMS[name], data=data, cfg=cfg, access=aw,
                device=dev, sampler=TorchSampler(0, dev),
                execution=mode).run()
            moved = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
            rounds = runs[mode].n_rounds
            assert moved["fedagg"] == rounds and moved["prox_sgd"] > 0
            assert COLLECTIVES["all_reduce"] == (2 * rounds if mode == "mesh"
                                                 else 0)
        host, mesh = runs["host"], runs["mesh"]
        assert [r.participants for r in host.rounds] == \
            [r.participants for r in mesh.rounds]
        for a, b in zip(host.params_history, mesh.params_history):
            for layer in a:
                for leaf in a[layer]:
                    assert (b[layer][leaf] == a[layer][leaf]).all()
    # A group whose CUDA backend is gloo: the collective is refused before
    # it runs.
    monkeypatch.setattr(dist, "get_backend_config",
                        lambda group=None: "cpu:gloo,cuda:gloo")
    t = torch.ones(2, device=dev)
    with pytest.raises(RuntimeError, match="NCCL"):
        all_reduce_sum(t, group)
    assert torch.equal(t, torch.ones(2, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_moe_ep_on_card_matches_one_row_view(dev, dtype):
    """Expert parallelism at one rank on NCCL against the row-local
    apply_moe on the one-row view (the same capacity, drops included):
    outputs, aux and gradients (f32 1e-5; bf16 2e-2)."""
    import dataclasses

    from repro_torch.models.lm.moe import apply_moe, apply_moe_ep, init_moe
    from repro_torch.models.lm.params import map_tree
    from repro_torch.sharding import COLLECTIVES, default_group, \
        reset_collectives
    cfg = dataclasses.replace(get_config("grok-1-314b").reduced().moe,
                              capacity_factor=1.5, n_shared=1)
    p = init_moe(torch.Generator(device=dev).manual_seed(0), 256, cfg,
                 "swiglu", device=dev, dtype=dtype)
    x = torch.randn((4, 96, 256), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(dtype)
    group = default_group(dev)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    outs = []
    for ep in (True, False):
        leaves = []
        pp = map_tree(lambda t: t.detach().clone().requires_grad_(True), p)
        map_tree(leaves.append, pp)
        xx = x.clone().requires_grad_(True)
        reset_collectives()
        if ep:
            y, aux = apply_moe_ep(pp, xx, cfg, "swiglu", group)
        else:
            y, aux = apply_moe(pp, xx.reshape(1, -1, 256), cfg, "swiglu")
            y = y.view(x.shape)
        loss = (y.float() ** 2).sum() + aux["load_balance"]
        grads = torch.autograd.grad(loss, [xx] + leaves)
        torch.cuda.synchronize()
        assert COLLECTIVES["all_to_all"] == (4 if ep else 0)
        outs.append((y, aux, grads))
    (y, aux, g), (y1, aux1, g1) = outs
    _close(y, y1, tol)
    for name in aux:
        _close(aux[name], aux1[name], tol)
    for a, b in zip(g, g1):
        _close(a, b, tol, tol * max(1.0, float(b.float().abs().max())))
