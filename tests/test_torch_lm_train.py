"""LM training through the port vs the reference, on the CPU.

Data (`data/tokens.py`) is held bitwise; the optimizers within 1e-6; the
training forward (`forward_train`), `lm_loss` within 1e-5 and every
gradient leaf within atol 1e-5 + rtol 1e-4 of `jax.grad`; three AdamW
steps of `make_train_step` within 1e-5 of the reference's jitted step;
the LM workloads' cost model exactly; `ConstellationSim` on `lm_tiny` and
`lm_hybrid_tiny` with the reference's draws (`JaxReplaySampler`):
RoundRecords bitwise, accuracy curves and final params within 1e-5.
Both packages get the same numpy inputs; the reference runs on the CPU
through its jnp paths (the Pallas kernels have no VJP), the port through
its kernels' plain versions (CPU tensors).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import restore_checkpoint as jax_restore
from repro.checkpoint.io import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core.workload import get_workload as jax_get_workload
from repro.data import tokens as jax_tokens
from repro.models.lm import transformer as jax_transformer
from repro.models.lm.config import ModelConfig as JaxModelConfig
from repro.optim import adam as jax_adam
from repro.optim import sgd as jax_sgd
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro.train import step as jax_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import ALGORITHMS, get_workload
from repro_torch.core.workload import lm_layout
from repro_torch.data import tokens
from repro_torch.launch import train
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.params import (
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.models.lm.transformer import forward_train, init_params
from repro_torch.optim import adam, sgd
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.orbits.access import AccessWindows
from repro_torch.params import ParamLayout
from repro_torch.sim import ConstellationSim, SimConfig
from repro_torch.train import step
from torch_parity import JaxReplaySampler

TOL = 1e-5


def _cfgs(arch: str):
    """(port config, reference config) of an LM: `lm_tiny`'s (the
    reference's `_lm_tiny`), or an --arch reduced."""
    if arch == "lm_tiny":
        kw = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
                  n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
                  head_dim=32, tie_embeddings=True, dtype="float32",
                  source="reduced dense decoder for constellation "
                         "fine-tuning")
        return ModelConfig(**kw), JaxModelConfig(**kw)
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


def _jax_params(jcfg, seed: int = 0) -> dict:
    return jax.device_get(jax_transformer.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def _tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close_trees(got, want, atol: float, rtol: float) -> None:
    """A tree of the port's tensors against a reference tree."""
    gl = tree_leaves(lm_params_to_numpy(got))
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert (np.abs(a - b) <= atol + rtol * np.abs(b)).all(), \
            float(np.abs(a - b).max())


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("batch,seq,vocab,seed", [(4, 33, 128, 0),
                                                  (2, 2048, 32001, 7)])
def test_synthetic_token_batch_is_bitwise(batch, seq, vocab, seed):
    got = tokens.synthetic_token_batch(batch, seq, vocab, seed=seed)
    want = jax_tokens.synthetic_token_batch(batch, seq, vocab, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_federated_token_shards_are_bitwise():
    got = tokens.federated_token_shards(5, seed=3, vocab=512)
    want = jax_tokens.federated_token_shards(5, seed=3, vocab=512)
    for f in ("x", "y", "n", "x_eval", "y_eval", "n_eval"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ------------------------------------------------------------- optimizers
def _opt_trees(seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "final_norm": (8,),
              "segments": [{"w": (2, 8, 8), "b": (2, 8)}] * 3}
    make = lambda s: rng.normal(size=s).astype(np.float32)
    p = {"embed": make((16, 8)), "final_norm": make((8,)),
         "segments": [{k: make(v) for k, v in seg.items()}
                      for seg in shapes["segments"]]}
    g = jax.tree.map(lambda a: make(a.shape), p)
    return p, g


def _port(tree) -> dict:
    return lm_params_from_jax(tree, "cpu")


def test_sgd_and_momentum_match_reference():
    p, g = _opt_trees()
    _close_trees(sgd.sgd_update(_port(p), _port(g), 0.1),
                 jax_sgd.sgd_update(p, g, 0.1), 1e-6, 0)
    state, jstate = sgd.momentum_init(_port(p)), jax_sgd.momentum_init(p)
    mine, theirs = _port(p), p
    for _ in range(3):
        mine, state = sgd.momentum_update(mine, _port(g), state, lr=0.05)
        theirs, jstate = jax_sgd.momentum_update(theirs, g, jstate, lr=0.05)
    _close_trees(mine, theirs, 1e-6, 0)
    _close_trees(state, jstate, 1e-6, 0)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_matches_reference(weight_decay):
    """Three AdamW steps (moments f32, bias corrections from the step)."""
    p, g = _opt_trees()
    mine, theirs = _port(p), jax.tree.map(jnp.asarray, p)
    state, jstate = adam.adam_init(mine), jax_adam.adam_init(theirs)
    for i in range(3):
        gi = jax.tree.map(lambda a: a * (i + 1), g)
        mine, state = adam.adam_update(mine, _port(gi), state, lr=1e-2,
                                       weight_decay=weight_decay)
        theirs, jstate = jax_adam.adam_update(theirs, gi, jstate, lr=1e-2,
                                              weight_decay=weight_decay)
    _close_trees(mine, jax.device_get(theirs), 1e-6, 0)
    _close_trees(state["mu"], jax.device_get(jstate["mu"]), 1e-6, 0)
    _close_trees(state["nu"], jax.device_get(jstate["nu"]), 1e-6, 0)
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_adam_keeps_bf16_params_and_f32_moments():
    p, g = _opt_trees()
    bf = map_tree(lambda t: t.to(torch.bfloat16), _port(p))
    state = adam.adam_init(bf)
    out, state = adam.adam_update(bf, map_tree(
        lambda t: t.to(torch.bfloat16), _port(g)), state)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(out))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["mu"]))


# ------------------------------------------------------ forward and grads
ARCHS = ["lm_tiny", "gemma-2b", "hymba-1.5b"]


def _grads(cfg, params, toks):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, metrics = step.lm_loss(cfg, params, {"tokens": toks})
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, map_tree(lambda _: next(grads), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch):
    """Logits and loss within 1e-5; every gradient leaf within atol 1e-5 +
    rtol 1e-4 of jax.grad of the reference's `lm_loss`."""
    cfg, jcfg = _cfgs(arch)
    jp = _jax_params(jcfg)
    toks = _tokens(cfg.vocab_size, (2, 33))
    params = lm_params_from_jax(jp, "cpu")
    logits, aux = forward_train(cfg, params, torch.as_tensor(toks).long())
    jlogits, jaux = jax_transformer.forward_train(jcfg, jp, jnp.asarray(toks))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=0)
    assert float(aux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_step.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    loss, metrics, grads = _grads(cfg, params, torch.as_tensor(toks).long())
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert abs(float(metrics[k].detach()) - float(jmetrics[k])) <= TOL, k
    _close_trees(grads, jax.device_get(jgrads), 1e-5, 1e-4)


def test_remat_gradients_equal_plain_gradients_bitwise():
    cfg, _ = _cfgs("hymba-1.5b")
    toks = torch.as_tensor(_tokens(cfg.vocab_size, (2, 33))).long()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, _, plain = _grads(cfg, params, toks)
    _, _, remat = _grads(dataclasses.replace(cfg, remat=True), params, toks)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain),
                                                 tree_leaves(remat)))


@pytest.mark.parametrize("arch", ["lm_tiny", "hymba-1.5b"])
def test_three_train_steps_match_reference(arch):
    """Three `make_train_step` (AdamW) steps against the reference's
    jitted step: every loss within 1e-5, the params within 1e-5 except
    where the first step's gradient is below 1e-5. There the gradient is
    rounding noise around zero (the packages' gradients agree to 1e-5,
    not in sign), and Adam's first step, m / sqrt(v) = sign(g), moves the
    element by up to lr either way: those elements (a handful a leaf; on
    hymba-1.5b reduced 1-4 of a leaf, found 3.5e-3 apart at lr 1e-3) are
    held to 2 lr per step, and to at most 1e-3 of each leaf."""
    lr = 1e-3
    cfg, jcfg = _cfgs(arch)
    jp = _jax_params(jcfg)
    params = lm_params_from_jax(jp, "cpu")
    opt, jopt = step.make_optimizer_state(params), \
        jax_step.make_optimizer_state(jp)
    train_step = step.make_train_step(cfg, lr=lr, remat=False)
    jax_train_step = jax.jit(jax_step.make_train_step(jcfg, lr=lr,
                                                      remat=False))
    noise = None
    for i in range(3):
        toks = _tokens(cfg.vocab_size, (2, 33), seed=i)
        params, opt, metrics = train_step(
            params, opt, {"tokens": torch.as_tensor(toks).long()})
        jp, jopt, jmetrics = jax_train_step(jp, jopt,
                                            {"tokens": jnp.asarray(toks)})
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= TOL
        if noise is None:       # first moment after step 1: 0.1 g
            noise = [np.abs(np.asarray(m)) < 0.1 * TOL
                     for m in jax.tree.leaves(jax.device_get(jopt["mu"]))]
    mine = jax.tree.leaves(lm_params_to_numpy(params))
    want = jax.tree.leaves(jax.device_get(jp))
    for a, b, n in zip(mine, want, noise):
        err = np.abs(a.astype(np.float64) - b)
        assert (err[~n] <= TOL).all(), float(err[~n].max())
        assert (err[n] <= 2 * lr * 3 + TOL).all()
        assert (err > TOL).sum() <= max(4, 1e-3 * n.size)


def test_client_losses_equal_one_client_at_a_time():
    """The stacked loss of the LM workloads (one forward for C clients)
    equals `lm_loss` of each client's own params and tokens."""
    cfg, _ = _cfgs("hymba-1.5b")
    layout = lm_layout(cfg)
    trees = [init_params(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in range(3)]
    stack = torch.stack([layout.pack(t) for t in trees])
    toks = torch.as_tensor(_tokens(cfg.vocab_size, (3, 4, 33))).long()
    got = step.client_lm_losses(cfg, layout.views(stack), toks)
    for c, tree in enumerate(trees):
        want, _ = step.lm_loss(cfg, tree, {"tokens": toks[c]})
        assert abs(float(got[c]) - float(want)) <= TOL


# ---------------------------------------------------------------- layout
def test_lm_layout_is_jax_leaf_order_with_segments_by_index():
    """Leaves in `jax.tree.leaves` order; with 12 segments, "segments/10"
    comes after "segments/9" (by index, not as a string)."""
    base = get_config("hymba-1.5b").reduced()
    seg = base.resolved_segments[0]
    cfg = dataclasses.replace(base, segments=(seg,) * 12, n_layers=12)
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layout = ParamLayout.of_tree(tree)
    paths = [p for p, _ in layout.leaves]
    assert paths.index("segments/10/attn/wk") > paths.index(
        "segments/9/ssm/out_proj")
    want = jax.tree.leaves(lm_params_to_numpy(tree))
    flat = layout.pack(tree)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([a.reshape(-1) for a in want]))
    views = layout.views(flat)
    assert isinstance(views["segments"], list) and len(views["segments"]) \
        == 12
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(views),
                                                 tree_leaves(tree)))


@pytest.mark.parametrize("name", ["lm_tiny", "lm_hybrid_tiny"])
def test_lm_workload_cost_model_matches_reference(name):
    wl, jwl = get_workload(name), jax_get_workload(name)
    for f in ("n_params", "model_bytes", "epoch_mflops", "inactive_params",
              "active_params", "samples_per_epoch", "bytes_per_param",
              "sample_shape", "sample_dtype"):
        assert getattr(wl, f) == getattr(jwl, f), f
    jtree = jax.device_get(jwl.init_fn(jax.random.PRNGKey(0)))
    assert [tuple(s) for _, s in wl.layout.leaves] == \
        [a.shape for a in jax.tree.leaves(jtree)]


# ------------------------------------------------------ constellation runs
HORIZON = 2 * 86400.0
RECORD_FIELDS = ("idx", "t_start", "t_end", "participants", "epochs",
                 "idle_s", "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes")


@pytest.fixture(scope="module")
def windows():
    return jax_windows(JaxWalkerStar(2, 2), jax_stations(1), horizon_s=HORIZON)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(-1)
                           for v in jax.tree.leaves(tree)])


@pytest.mark.parametrize("workload", ["lm_tiny", "lm_hybrid_tiny"])
@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_constellation_run_matches_reference(workload, name, windows):
    """c2s2/g1, 2 rounds with the reference's init and minibatch draws:
    RoundRecords bitwise, accuracy curves and final params within 1e-5."""
    aw = windows
    kw = dict(max_rounds=2, horizon_s=HORIZON, eval_every=1, max_steps=4,
              batch_size=8)
    ref = JaxSim(JaxWalkerStar(2, 2), jax_stations(1), JAX_ALGORITHMS[name],
                 cfg=JaxConfig(**kw), access=aw, workload=workload).run()
    paw = AccessWindows(aw.per_sat, aw.per_sat_station, aw.cluster,
                        aw.horizon_s, aw.dt_s)
    res = ConstellationSim(
        WalkerStar(2, 2), station_subnetwork(1), ALGORITHMS[name],
        cfg=SimConfig(**kw), access=paw, workload=workload, device="cpu",
        sampler=JaxReplaySampler(0)).run()
    assert len(ref.rounds) == 2
    rec = lambda r: [[getattr(x, f) for f in RECORD_FIELDS] for x in r.rounds]
    assert rec(res) == rec(ref)
    assert [(i, t) for i, t, _ in res.accuracy_curve] == \
        [(i, t) for i, t, _ in ref.accuracy_curve]
    np.testing.assert_allclose([a for *_, a in res.accuracy_curve],
                               [a for *_, a in ref.accuracy_curve],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_flat(res.final_params),
                               _flat(ref.final_params), atol=TOL, rtol=0)


# -------------------------------------------------- launcher, checkpoints
def test_train_launcher_runs_on_cpu(tmp_path):
    done = train.main(["--arch", "hymba-1.5b", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "33",
                       "--ckpt", str(tmp_path / "ckpt")])
    assert done["steps"] == 2 and len(done["losses"]) == 2
    assert np.isfinite(done["losses"]).all()
    meta = json.loads((tmp_path / "ckpt.json").read_text())
    assert meta["step"] == 2
    # The reference restores the port's checkpoint.
    jcfg = jax_get_config("hymba-1.5b").reduced()
    back = jax_restore(str(tmp_path / "ckpt"), _jax_params(jcfg))
    assert [a.shape for a in jax.tree.leaves(back)] == \
        [a.shape for a in jax.tree.leaves(_jax_params(jcfg))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_read(tmp_path, dtype):
    """A tree written by either package reads back bitwise in the other,
    bf16 leaves included, with the same JSON sidecar."""
    cfg, jcfg = _cfgs("hymba-1.5b")
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jp = _jax_params(jcfg)
    jax_save(str(tmp_path / "ref"), jp, step=3)
    like = map_tree(torch.zeros_like, lm_params_from_jax(jp, "cpu"))
    mine = restore_checkpoint(str(tmp_path / "ref"), like)
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(mine),
                                                 tree_leaves(like)))
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(mine)),
                    jax.tree.leaves(jp)):
        assert np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8))
    save_checkpoint(str(tmp_path / "port"), mine, step=3)
    back = jax_restore(str(tmp_path / "port"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a).view(np.uint8),
                              np.asarray(b).view(np.uint8))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())
