"""The port's CUDA kernels and main path on a card (skipped without one).

Run on a machine with an NVIDIA Hopper card and `nvcc`:

    python -m pytest -q tests/test_torch_cuda.py

The kernels are built from `src/repro_torch/csrc/` at first use. Each is
held against its plain PyTorch version on the same card inputs with the
tolerances of `tests/test_kernels.py` (2e-5 in f32, 2e-2 in bf16). This
file imports neither `jax` nor `repro`, so it runs where only the port is
installed.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core import ALGORITHMS
from repro_torch.data import synth_femnist
from repro_torch.kernels import ops, ref
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


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,p", [(10, P_MLP), (100, P_MLP), (7, 12345),
                                 (1, 1)])
@pytest.mark.parametrize("delta", [False, True])
def test_fedagg_kernel_matches_plain(dev, k, p, dtype, delta):
    g = torch.Generator(device=dev).manual_seed(k * p)
    x = torch.randn((k, p), generator=g, device=dev).to(dtype)
    w = torch.rand((k,), generator=g, device=dev)
    base = torch.randn((p,), generator=g, device=dev).to(dtype) \
        if delta else None
    before = ops.LAUNCHES["fedagg"]
    got = ops.fedagg_op(x, w, base, 0.5 if delta else 1.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedagg"] == before + 1
    assert got.dtype == dtype and got.shape == (p,)
    _close(got, ref.fedagg_ref(x, w, base, 0.5 if delta else 1.0), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# P = 46,639 is odd, so the main path takes the scalar loop; (4, 4096)
# takes the 16-byte vector loop.
@pytest.mark.parametrize("c,p", [(10, P_MLP), (4, 4096), (3, 4099), (2, 3)])
@pytest.mark.parametrize("mu", [0.0, 0.1])
@pytest.mark.parametrize("shared_anchor", [True, False])
def test_prox_sgd_kernel_matches_plain(dev, c, p, dtype, mu, shared_anchor):
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
    masked = steps <= 4
    assert torch.equal(got[masked], w[masked])         # bitwise no-op


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
            assert all(v > 0 for v in moved.values()), moved
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
