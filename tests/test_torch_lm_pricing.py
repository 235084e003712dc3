"""Every published LM priced as a constellation client, against the
reference.

(a) For each of the 10 archs at full width, every cost field of
    `lm_workload` and of `HardwareModel.for_workload` equals the
    reference's, and the layout's leaf shapes (built on `meta`, nothing
    allocated) equal `jax.eval_shape` of the reference's init.
(b) Timing-only runs (`SimConfig(train=False)`) on c2s5/g3 over 30 days,
    3 rounds of `fedavg_sched` and `fedbuff`, with one `AccessWindows`
    passed to both packages: RoundRecords and totals bitwise. The three
    largest (deepseek-v3, grok-1, qwen1.5-110b) never fit a contact, so
    `fedavg_sched` runs 0 rounds of them in both.
(c) Training refuses where the reference fails: `train=True` with a bf16
    config or with whisper raises `ValueError` before any round; the
    reference's own client loop fails on a bf16 stack.
"""
from __future__ import annotations

import dataclasses

import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core import lm_workload as jax_lm_workload
from repro.core.timing import HardwareModel as JaxHardwareModel
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.core import ALGORITHMS, lm_workload
from repro_torch.core.timing import HardwareModel
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.sim import ConstellationSim, SimConfig

ARCHS = lm_arch_ids()
HORIZON = 30 * 86400.0
NEVER_FIT = ("deepseek-v3-671b", "grok-1-314b", "qwen1.5-110b")
COST_FIELDS = ("n_params", "inactive_params", "active_params",
               "bytes_per_param", "model_bytes", "epoch_mflops",
               "samples_per_epoch", "train_flops_per_param")


@pytest.fixture(scope="module")
def workloads() -> dict:
    """(port, reference) workload per arch, each built once."""
    return {a: (lm_workload(get_config(a)), jax_lm_workload(jax_get_config(a)))
            for a in ARCHS}


@pytest.fixture(scope="module")
def windows():
    return jax_windows(JaxWalkerStar(2, 5), jax_stations(3),
                       horizon_s=HORIZON)


# --------------------------------------------------------------------- #
# (a) cost fields and layout shapes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_fields_equal_reference(arch, workloads):
    mine, ref = workloads[arch]
    for f in COST_FIELDS:
        assert getattr(mine, f) == getattr(ref, f), f
    assert type(mine.model_bytes) is int and type(mine.n_params) is int
    hw, jhw = HardwareModel.for_workload(mine), \
        JaxHardwareModel.for_workload(ref)
    for f in dataclasses.fields(jhw):
        assert getattr(hw, f.name) == getattr(jhw, f.name), f.name
    assert (hw.epoch_time_s, hw.tx_time_s, hw.ul_time_s) == \
        (jhw.epoch_time_s, jhw.tx_time_s, jhw.ul_time_s)


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_shapes_equal_eval_shape(arch, workloads):
    mine, ref = workloads[arch]
    shapes = jax.eval_shape(ref.init_fn, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(leaf.shape))
            for path, leaf in flat]
    assert list(mine.layout.leaves) == want


def test_full_width_layouts_allocate_nothing(workloads):
    """deepseek-v3's 671,953,083,392 params price without a byte of
    storage: the layout holds shapes only."""
    mine, _ = workloads["deepseek-v3-671b"]
    assert mine.n_params == 671_953_083_392
    assert all(isinstance(shape, tuple) for _, shape in mine.layout.leaves)


# --------------------------------------------------------------------- #
# (b) timing-only constellation runs, one shared AccessWindows
# --------------------------------------------------------------------- #
def _records(res) -> list[dict]:
    return [dataclasses.asdict(r) for r in res.rounds]


@pytest.mark.parametrize("alg", ["fedavg_sched", "fedbuff"])
@pytest.mark.parametrize("arch", ARCHS)
def test_timing_only_runs_equal_reference(arch, alg, workloads, windows):
    mine, ref = workloads[arch]
    kw = dict(max_rounds=3, horizon_s=HORIZON, train=False)
    got = ConstellationSim(WalkerStar(2, 5), station_subnetwork(3),
                           ALGORITHMS[alg], cfg=SimConfig(**kw),
                           access=windows, workload=mine,
                           device="cpu").run()
    want = JaxSim(JaxWalkerStar(2, 5), jax_stations(3), JAX_ALGORITHMS[alg],
                  cfg=JaxConfig(**kw), access=windows, workload=ref).run()
    assert _records(got) == _records(want)
    assert got.summary() == want.summary()
    assert (got.total_time_s, got.mean_round_duration_s,
            got.mean_idle_per_round_s) == \
        (want.total_time_s, want.mean_round_duration_s,
         want.mean_idle_per_round_s)
    # A synchronous round needs the transfer inside one contact; FedBuff's
    # uploads span contacts in both packages.
    never = arch in NEVER_FIT and alg == "fedavg_sched"
    assert got.n_rounds == (0 if never else 3)


# --------------------------------------------------------------------- #
# (c) training refuses where the reference fails
# --------------------------------------------------------------------- #
class _NoDraws:
    """A sampler that fails the test if the engine draws anything."""

    def init(self, workload):
        raise AssertionError("a timing-only run initialised params")

    def minibatches(self, *a):
        raise AssertionError("a timing-only run drew minibatches")

    def codec_uniforms(self, *a):
        raise AssertionError("a timing-only run drew codec uniforms")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-medium"])
def test_training_refuses_before_any_round(arch, windows):
    wl = lm_workload(get_config(arch))
    match = "frame embeddings" if arch == "whisper-medium" else "bfloat16"
    with pytest.raises(ValueError, match=match):
        ConstellationSim(WalkerStar(2, 5), station_subnetwork(3),
                         ALGORITHMS["fedavg"], access=windows, workload=wl,
                         cfg=SimConfig(max_rounds=1, horizon_s=HORIZON),
                         device="cpu", sampler=_NoDraws())
    # Timing only, the same workload runs without params or data.
    sim = ConstellationSim(WalkerStar(2, 5), station_subnetwork(3),
                           ALGORITHMS["fedavg"], access=windows, workload=wl,
                           cfg=SimConfig(max_rounds=1, horizon_s=HORIZON,
                                         train=False),
                           device="cpu", sampler=_NoDraws())
    assert sim.run().n_rounds == 1 and sim.data is None


def test_reduced_bf16_and_encdec_refuse_to_train():
    """The refusal follows the config, not its size."""
    for cfg in (dataclasses.replace(get_config("hymba-1.5b").reduced(),
                                    dtype="bfloat16"),
                get_config("whisper-medium").reduced()):
        wl = lm_workload(cfg)
        assert wl.train_refusal is not None
        with pytest.raises(ValueError, match="reference"):
            ConstellationSim(WalkerStar(1, 2), station_subnetwork(1),
                             ALGORITHMS["fedavg"], workload=wl,
                             cfg=SimConfig(max_rounds=1,
                                           horizon_s=2 * 86400.0),
                             device="cpu")
    assert lm_workload(get_config("hymba-1.5b").reduced()).train_refusal \
        is None


def test_reference_fails_to_train_a_bf16_stack():
    """The reference's client loop cannot carry a bf16 stack: `p - lr *
    live * gi` comes back f32 (`repro/core/client.py`), so its
    `fori_loop` refuses the carry."""
    cfg = dataclasses.replace(jax_get_config("hymba-1.5b").reduced(),
                              dtype="bfloat16")
    wl = jax_lm_workload(cfg, samples_per_client=4, eval_samples=2)
    cst = JaxWalkerStar(1, 2)
    st = jax_stations(1)
    aw = jax_windows(cst, st, horizon_s=2 * 86400.0)
    with pytest.raises(TypeError, match="carry"):
        JaxSim(cst, st, JAX_ALGORITHMS["fedavg"], workload=wl, access=aw,
               cfg=JaxConfig(max_rounds=1, horizon_s=2 * 86400.0,
                             max_steps=2, batch_size=2)).run()
