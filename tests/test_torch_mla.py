"""The port's MLA attention, MTP head, deepseek-v3 and `lm_moe_tiny` vs the
JAX reference, on the CPU.

Both packages get the same numpy inputs and weights (the reference's init
carried across with `lm_params_from_jax`). The reference's MLA attends in
jnp (`attention_prefill`, whose value head dim Dv may differ from the
keys' D; its Pallas kernel takes Dv = D only), so its functions are the
oracle; the port attends through the `flash_attention` kernel's plain
version (CPU tensors) at (D, Dv) = (96, 64) reduced and (192, 128) at
full width. The plain forward within 1e-5 of `attention_prefill` and the
plain backward within 1e-5 of autograd of the plain forward; `mla_prefill`
(output and the (c_kv, k_rope) cache) and 4 absorbed decode steps within
1e-5; reduced deepseek-v3 (MLA, routed experts with a shared one, the MTP
head): logits, `moe_aux` and `mtp_logits` within 1e-5, the loss and each
metric within 1e-5, every gradient leaf within 1e-5 + 1e-4 relative of
`jax.grad`, prefill and 8 greedy decode steps within 1e-4 with identical
tokens; `lm_moe_tiny`'s cost model equal to the reference's, and its
constellation runs with the reference's draws: RoundRecords bitwise,
accuracy within 1e-5, params within 1e-5 after one local step and after
2 rounds.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core.workload import get_workload as jax_get_workload
from repro.models.lm import attention as jattn
from repro.models.lm import mla as jmla
from repro.models.lm.transformer import forward_train as jax_forward_train
from repro.models.lm.transformer import init_params as jax_init_params
from repro.models.lm.transformer import prefill as jax_prefill
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro.train import step as jax_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.core import ALGORITHMS, get_workload
from repro_torch.core.workload import lm_layout
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, train
from repro_torch.models.lm import mla
from repro_torch.models.lm.params import (
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.models.lm.transformer import (
    forward_train,
    forward_train_stacked,
    init_params,
    prefill,
)
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.orbits.access import AccessWindows
from repro_torch.sim import ConstellationSim, SimConfig
from repro_torch.train import step
from repro_torch.train.step import make_prefill_step, make_serve_step
from torch_parity import JaxReplaySampler

TOL = 1e-5
ARCH = "deepseek-v3-671b"


def _cfgs():
    """lm_moe_tiny's model: deepseek-v3 reduced to 4 layers (3 dense MLA,
    1 MoE of 8 experts), in both packages."""
    return (get_config(ARCH).reduced(n_layers=4, n_experts=8),
            jax_get_config(ARCH).reduced(n_layers=4, n_experts=8))


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


# ------------------------------------------------- the kernel's plain version
@pytest.mark.parametrize("D,Dv", [(96, 64), (192, 128)])
@pytest.mark.parametrize("S", [33, 130])
def test_flash_ref_with_dv_matches_attention_prefill(D, Dv, S):
    """Causal GQA (4 query heads on 2 KV heads) with values narrower than
    the keys: the plain forward against the reference's jnp attention
    (the scale is the keys' D^-1/2)."""
    rng = np.random.default_rng(S + D)
    qj, qt = _pair(rng.normal(size=(2, S, 4, D)))
    kj, kt = _pair(rng.normal(size=(2, S, 2, D)))
    vj, vt = _pair(rng.normal(size=(2, S, 2, Dv)))
    pos = jnp.arange(S)
    want = jattn.attention_prefill(qj, kj, vj, pos, pos, q_chunk=64)
    got = ref.flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                  vt.transpose(1, 2)).transpose(1, 2)
    assert got.shape == (2, S, 4, Dv)
    _close(got, want)


@pytest.mark.parametrize("D,Dv", [(96, 64), (192, 128)])
def test_flash_bwd_ref_with_dv_matches_autograd(D, Dv):
    """The plain backward's formulas (what the kernel computes) against
    torch autograd of the plain forward, with the forward's lse and
    recomputing it; and `flash_attention_op`'s backward on the CPU."""
    rng = np.random.default_rng(D)
    S = 45
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 4, S, D), (2, 2, S, D), (2, 2, S, Dv)))
    do = torch.as_tensor(rng.normal(size=(2, 4, S, Dv)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves), leaves, do)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    for saved in (lse, None):
        got = ref.flash_attention_bwd_ref(q, k, v, o, do, lse=saved)
        for a, w in zip(got, want):
            assert a.shape == w.shape
            _close(a, w)
    got = torch.autograd.grad(ops.flash_attention_op(*leaves), leaves, do)
    for a, w in zip(got, want):
        _close(a, w)


# ------------------------------------------------------------ the MLA layer
@functools.lru_cache(maxsize=None)
def _mla_tree():
    """The reference's MLA init at the reduced dims, with its zero norm
    scales made random so that they show."""
    _, jcfg = _cfgs()
    tree = jax.device_get(jmla.init_mla(jax.random.PRNGKey(0), jcfg.d_model,
                                        jcfg.n_heads, jcfg.mla))
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    rng = np.random.default_rng(0)
    for name in ("q_norm", "kv_norm"):
        tree[name] = (0.1 * rng.normal(size=tree[name].shape)).astype(
            np.float32)
    return tree


@pytest.mark.parametrize("T", [33, 130])
def test_mla_prefill_and_absorbed_decode_match(T):
    """`mla_prefill`'s output and (c_kv, k_rope) cache, then 4 absorbed
    decode steps against the cache (written in place), each step's
    output and the cache within 1e-5."""
    cfg, jcfg = _cfgs()
    tree = _mla_tree()
    pj = {k: jnp.asarray(v) for k, v in tree.items()}
    pt = lm_params_from_jax(tree, "cpu")
    H, theta = cfg.n_heads, cfg.rope_theta
    rng = np.random.default_rng(T)
    xj, xt = _pair(rng.normal(size=(2, T, cfg.d_model)))
    out_j, (ckv_j, kr_j) = jmla.mla_prefill(pj, xj, H, jcfg.mla,
                                            jnp.arange(T), theta)
    out_t, (ckv_t, kr_t) = mla.mla_prefill(pt, xt, H, cfg.mla,
                                           torch.arange(T), theta)
    _close(out_t, out_j)
    _close(ckv_t, ckv_j)
    _close(kr_t, kr_j)
    smax = T + 4
    pad = lambda a: jnp.pad(a, ((0, 0), (0, smax - T), (0, 0)))
    cache_j = (pad(ckv_j), pad(kr_j))
    c_kv = torch.zeros((2, smax, cfg.mla.kv_lora_rank))
    k_rope = torch.zeros((2, smax, cfg.mla.rope_head_dim))
    c_kv[:, :T], k_rope[:, :T] = ckv_t, kr_t
    for pos in range(T, smax):
        xj, xt = _pair(rng.normal(size=(2, 1, cfg.d_model)))
        oj, cache_j = jmla.mla_decode(pj, xj, cache_j, pos, H, jcfg.mla,
                                      theta)
        ot = mla.mla_decode(pt, xt, c_kv, k_rope, pos, H, cfg.mla, theta)
        _close(ot, oj)
        _close(c_kv, cache_j[0])
        _close(k_rope, cache_j[1])


def test_mla_stacked_launches_one_attention_a_layer_for_the_stack(
        monkeypatch):
    """A 2-client stack trains through one attention call a layer at
    (D, Dv) = (96, 64), the clients folded into its batch, and its
    losses equal each client's own `lm_loss` (MTP term included)."""
    cfg, _ = _cfgs()
    layout = lm_layout(cfg)
    trees = [init_params(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in range(2)]
    stack = layout.views(torch.stack([layout.pack(t) for t in trees]))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 3, 33))).long()
    calls = []
    plain = ref.flash_attention_ref

    def count(q, k, v, *args, **kw):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return plain(q, k, v, *args, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", count)
    got = step.client_lm_losses(cfg, stack, toks)
    assert calls == [((6, 4, 33, 96), (6, 4, 33, 64))] * 4
    monkeypatch.undo()
    for c, tree in enumerate(trees):
        want, metrics = step.lm_loss(cfg, tree, {"tokens": toks[c]})
        assert "mtp" in metrics
        assert abs(float(got[c]) - float(want)) <= TOL


# ------------------------------------------------------------ whole model
@functools.lru_cache(maxsize=None)
def _jax_tree():
    _, jcfg = _cfgs()
    return jax.device_get(jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))


def test_init_has_the_references_leaves():
    """The MLA and MTP leaves, names and shapes, as the reference's tree
    (so `lm_params_from_jax` carries every leaf across), and 3,904,128
    params."""
    cfg, _ = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mine = tree_leaves(lm_params_to_numpy(params))
    want = jax.tree.leaves(_jax_tree())
    assert [a.shape for a in mine] == [a.shape for a in want]
    assert sorted(params["segments"][0]) == ["mla", "mlp", "norm1", "norm2"]
    assert sorted(params["segments"][1]) == ["mla", "moe", "norm1", "norm2"]
    assert params["mtp_head"].shape == (cfg.d_model, cfg.vocab_size)
    assert sum(a.size for a in mine) == 3_904_128


def test_forward_train_logits_aux_and_mtp_match():
    cfg, jcfg = _cfgs()
    jp = _jax_tree()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 33),
                                             dtype=np.int32)
    logits, aux = forward_train(cfg, lm_params_from_jax(jp, "cpu"),
                                torch.as_tensor(toks).long())
    jlogits, jaux = jax_forward_train(jcfg, jp, jnp.asarray(toks))
    assert sorted(aux) == sorted(jaux) == ["moe_aux", "mtp_logits"]
    _close(logits, jlogits)
    _close(aux["mtp_logits"], jaux["mtp_logits"])
    assert aux["moe_aux"].shape == () and float(jaux["moe_aux"]) > 0
    _close(aux["moe_aux"], jaux["moe_aux"])


def _grads(cfg, params, toks):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, metrics = step.lm_loss(cfg, params, {"tokens": toks})
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics, map_tree(lambda _: next(grads), params)


@pytest.mark.parametrize("seq", [33, 65])
def test_loss_metrics_and_grads_match_reference(seq):
    """Global (33 tokens) and row-local (65) expert dispatch: the loss and
    each metric (ce, moe_aux, mtp, loss) within 1e-5, every gradient leaf
    (MLA's projections through the plain flash backward at Dv != D, the
    MTP head) within atol 1e-5 + rtol 1e-4 of jax.grad."""
    cfg, jcfg = _cfgs()
    jp = _jax_tree()
    toks = np.random.default_rng(seq).integers(0, cfg.vocab_size, (2, seq),
                                               dtype=np.int32)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_step.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    loss, metrics, grads = _grads(cfg, lm_params_from_jax(jp, "cpu"),
                                  torch.as_tensor(toks).long())
    assert sorted(metrics) == sorted(jmetrics) == ["ce", "loss", "moe_aux",
                                                   "mtp"]
    for k in metrics:
        assert abs(float(metrics[k].detach()) - float(jmetrics[k])) <= TOL, k
    assert abs(float(loss) - float(jloss)) <= TOL
    gl = tree_leaves(lm_params_to_numpy(grads))
    wl = jax.tree.leaves(jax.device_get(jgrads))
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)).all(), \
            float(np.abs(a - b).max())


@functools.lru_cache(maxsize=None)
def _jax_steps(max_seq: int):
    _, jcfg = _cfgs()
    return (jax.jit(lambda p, t: jax_prefill(jcfg, p, t, max_seq)),
            jax.jit(jax_make_serve_step(jcfg)))


@pytest.mark.parametrize("prompt_len", [33, 130])
def test_reduced_deepseek_prefill_and_decode_match(prompt_len):
    """Prefill (one flash_attention call a layer at Dv != D; the routed
    experts global at 33 tokens, row-local at 130), then 8 greedy decode
    steps in the absorbed form: logits within 1e-4, identical tokens, the
    (c_kv, k_rope) caches within 1e-4."""
    cfg, _ = _cfgs()
    max_seq = prompt_len + 16
    jprefill, jstep = _jax_steps(max_seq)
    tree = _jax_tree()
    params = lm_params_from_jax(tree, "cpu")
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    jlogits, jcache = jprefill(tree, jnp.asarray(prompts))
    logits, cache = make_prefill_step(cfg, max_seq)(
        params, {"tokens": torch.as_tensor(prompts, dtype=torch.int64)})
    _close(logits, jlogits, 1e-4)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    serve_step = make_serve_step(cfg)
    for _ in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jtok, jlogits, jcache = jstep(tree, jtok, jcache)
        tok, logits, cache = serve_step(params, tok, cache)
        _close(logits, jlogits, 1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for got, want in zip(cache["segments"], jcache["segments"]):
        assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
        for name in want:
            _close(got[name], want[name], 1e-4)


def test_decode_cache_holds_the_latent_only():
    """The MLA cache: c_kv (kv_lora_rank) and k_rope (rope_head_dim) a
    token a layer, in the model's dtype, no per-head k / v."""
    import dataclasses
    cfg = dataclasses.replace(_cfgs()[0], dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, cache = prefill(cfg, params, torch.zeros((2, 5), dtype=torch.int64),
                       40)
    for seg, n in zip(cache["segments"], (3, 1)):
        assert seg["c_kv"].shape == (n, 2, 40, 32)
        assert seg["k_rope"].shape == (n, 2, 40, 32)
        assert all(t.dtype == torch.bfloat16 for t in seg.values())


def test_forward_train_stacked_equals_single_client_forwards():
    """G = 2 clients at once: each client's logits, aux and MTP logits
    equal its own forward's."""
    cfg, _ = _cfgs()
    trees = [init_params(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in range(2)]
    stack = map_tree(lambda *ts: torch.stack(ts), *trees)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 2, 65))).long()
    logits, aux = forward_train_stacked(cfg, stack, toks)
    assert aux["moe_aux"].shape == (2,)
    assert aux["mtp_logits"].shape == (2, 2, 65, cfg.vocab_size)
    for g in range(2):
        lg, ag = forward_train(cfg, trees[g], toks[g])
        torch.testing.assert_close(logits[g], lg, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(aux["mtp_logits"][g], ag["mtp_logits"],
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(aux["moe_aux"][g], ag["moe_aux"],
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- the workload
def test_lm_moe_tiny_cost_model_matches_reference():
    wl, jwl = get_workload("lm_moe_tiny"), jax_get_workload("lm_moe_tiny")
    assert wl.n_params == 3_904_128
    for f in ("n_params", "model_bytes", "epoch_mflops", "inactive_params",
              "active_params", "samples_per_epoch", "bytes_per_param",
              "sample_shape", "sample_dtype"):
        assert getattr(wl, f) == getattr(jwl, f), f
    jtree = jax.device_get(jwl.init_fn(jax.random.PRNGKey(0)))
    assert [tuple(s) for _, s in wl.layout.leaves] == \
        [a.shape for a in jax.tree.leaves(jtree)]


HORIZON = 2 * 86400.0
RECORD_FIELDS = ("idx", "t_start", "t_end", "participants", "epochs",
                 "idle_s", "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes")


@pytest.fixture(scope="module")
def windows():
    aw = jax_windows(JaxWalkerStar(2, 2), jax_stations(1), horizon_s=HORIZON)
    paw = AccessWindows(aw.per_sat, aw.per_sat_station, aw.cluster,
                        aw.horizon_s, aw.dt_s)
    return aw, paw


def _runs(windows, name: str, rounds: int, steps: int):
    """The reference's run and the port's of `lm_moe_tiny` on c2s2/g1 with
    the reference's draws."""
    aw, paw = windows
    kw = dict(max_rounds=rounds, horizon_s=HORIZON, eval_every=1,
              max_steps=steps, batch_size=8)
    ref_run = JaxSim(JaxWalkerStar(2, 2), jax_stations(1),
                     JAX_ALGORITHMS[name], cfg=JaxConfig(**kw), access=aw,
                     workload="lm_moe_tiny").run()
    port_run = ConstellationSim(
        WalkerStar(2, 2), station_subnetwork(1), ALGORITHMS[name],
        cfg=SimConfig(**kw), access=paw, workload="lm_moe_tiny",
        device="cpu", sampler=JaxReplaySampler(0)).run()
    return ref_run, port_run


def _records(res) -> list:
    return [[getattr(x, f) for f in RECORD_FIELDS] for x in res.rounds]


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(-1)
                           for v in jax.tree.leaves(tree)])


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
@pytest.mark.parametrize("rounds,steps", [(1, 1), (2, 4)])
def test_lm_moe_tiny_constellation_run_matches_reference(name, rounds, steps,
                                                         windows):
    """One round of one local step, and 2 rounds of up to 4 local steps:
    RoundRecords bitwise, the accuracy curve and the final params within
    1e-5 of the reference's (every client trains through MLA, the MoE
    layer and the MTP head)."""
    ref_run, res = _runs(windows, name, rounds=rounds, steps=steps)
    assert len(ref_run.rounds) == rounds
    assert _records(res) == _records(ref_run)
    np.testing.assert_allclose([a for *_, a in res.accuracy_curve],
                               [a for *_, a in ref_run.accuracy_curve],
                               atol=TOL, rtol=0)
    mine = _flat(res.final_params)
    assert mine.size == 3_904_128 and np.isfinite(mine).all()
    np.testing.assert_allclose(mine, _flat(ref_run.final_params), atol=TOL,
                               rtol=0)


# ------------------------------------------------------------ launchers
def test_serve_and_train_launchers_run_deepseek_on_cpu():
    done, tokens, logits = serve.main([
        "--arch", ARCH, "--device", "cpu", "--requests", "2", "--batch", "2",
        "--prompt-len", "70", "--max-new", "3"])
    assert done["requests"] == 2 and tokens.shape == (2, 4)
    assert bool(torch.isfinite(logits).all())
    done = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "33"])
    assert len(done["losses"]) == 2 and np.isfinite(done["losses"]).all()
