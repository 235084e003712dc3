"""The port's examples (`examples/torch/*.py`) against the reference's own
examples (`examples/*.py`), each run in-process on the CPU.

(a) constellation_sweep `--rounds 5`: the printed table line for line,
    and every cell's numbers bitwise the reference run's.
(b) quickstart: RoundRecords bitwise, the accuracy curve within 1e-5,
    through `JaxReplaySampler` (the reference's init and minibatches).
(c) constellation_llm `--rounds 2 --max-steps 2`, host and mesh (the
    port's one-rank default group): RoundRecords bitwise, accuracy within
    1e-5 of the reference's run of the same execution.
(d) serve_llm `--tokens 4`, gemma-2b (attention) and rwkv6-1.6b (the
    `wkv6` scan), with the reference's weights carried in by
    `lm_params_from_jax`: the generated tokens equal the reference's.

Each reference example reads `sys.argv` and returns nothing, so the test
sets `sys.argv` and records the reference's `ConstellationSim` results
through a subclass put in the example module's namespace.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.core import lm_workload as jax_lm_workload
from repro.models.lm import init_params as jax_init_params
from repro.models.lm.transformer import prefill as jax_prefill
from repro.train.step import make_serve_step as jax_serve_step
from repro_torch.models.lm.params import lm_params_from_jax
from torch_parity import JaxReplaySampler

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = ("quickstart", "constellation_sweep", "constellation_llm",
            "serve_llm")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples() -> dict:
    out = {}
    for ex in EXAMPLES:
        out[ex] = (_load(os.path.join(ROOT, "examples", f"{ex}.py"),
                         f"_ref_example_{ex}"),
                   _load(os.path.join(ROOT, "examples", "torch", f"{ex}.py"),
                         f"_torch_example_{ex}"))
    return out


def _run_reference(mod, argv, monkeypatch) -> list:
    """Run a reference example's `main` with `argv`; returns the results
    of every `ConstellationSim.run()` it made, in order."""
    runs = []
    base = mod.ConstellationSim

    class Recording(base):
        def run(self):
            res = super().run()
            runs.append(res)
            return res

    monkeypatch.setattr(mod, "ConstellationSim", Recording)
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    mod.main()
    return runs


def _records(rounds) -> list[dict]:
    out = []
    for r in rounds:
        d = dataclasses.asdict(r)
        d.pop("accuracy")
        out.append(d)
    return out


def _assert_accuracy_close(mine, ref):
    assert [a is None for a in mine] == [a is None for a in ref]
    for a, b in zip(mine, ref):
        if a is not None:
            assert abs(a - b) <= 1e-5


def test_examples_exist_with_the_reference_flags(examples):
    """Each port example takes the reference's flags plus `--device`, and
    its `main` returns the numbers it prints."""
    for ex, (ref, mine) in examples.items():
        assert callable(mine.main), ex
        with open(ref.__file__) as fh:
            ref_src = fh.read()
        with open(mine.__file__) as fh:
            mine_src = fh.read()
        flags = [f for f in ("--arch", "--rounds", "--sats", "--seq", "--lr",
                             "--batch", "--max-steps", "--alg", "--execution",
                             "--prompt-len", "--tokens")
                 if f'"{f}"' in ref_src]
        for f in flags + ["--device"]:
            assert f'"{f}"' in mine_src, (ex, f)


# --------------------------------------------------------------------- #
# (a) the paper's headline sweep, timing only
# --------------------------------------------------------------------- #
def test_constellation_sweep_prints_the_reference_table(examples, capsys,
                                                       monkeypatch):
    ref_mod, mine = examples["constellation_sweep"]
    ref_runs = _run_reference(ref_mod, ["--rounds", "5"], monkeypatch)
    ref_out = capsys.readouterr().out
    got = mine.main(["--rounds", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines() == ref_out.splitlines()
    assert len(out.splitlines()) == 2 + 12
    cells = list(got["cells"].values())
    assert len(cells) == len(ref_runs) == 12
    for cell, ref in zip(cells, ref_runs):
        assert cell == {"round_s": ref.mean_round_duration_s,
                        "total_s": ref.total_time_s,
                        "idle_s": ref.mean_idle_per_round_s,
                        "n_rounds": ref.n_rounds}
    assert got["device"] == "cpu"


# --------------------------------------------------------------------- #
# (b) the README's quickstart, trained
# --------------------------------------------------------------------- #
def test_quickstart_matches_reference(examples, capsys, monkeypatch):
    ref_mod, mine = examples["quickstart"]
    (ref,) = _run_reference(ref_mod, [], monkeypatch)
    capsys.readouterr()
    got = mine.main(["--device", "cpu"], sampler=JaxReplaySampler(0))
    out = capsys.readouterr().out
    assert len(ref.rounds) == 15
    assert _records(got["rounds"]) == _records(ref.rounds)
    _assert_accuracy_close([r.accuracy for r in got["rounds"]],
                           [r.accuracy for r in ref.rounds])
    assert [(i, t) for i, t, _ in got["accuracy_curve"]] == \
        [(i, t) for i, t, _ in ref.accuracy_curve]
    _assert_accuracy_close([a for *_, a in got["accuracy_curve"]],
                           [a for *_, a in ref.accuracy_curve])
    # The summary's accuracies are rounded to 4 decimals; the rest is
    # timing, bitwise.
    acc = ("max_accuracy", "final_accuracy")
    want = ref.summary()
    assert {k: v for k, v in got["summary"].items() if k not in acc} == \
        {k: v for k, v in want.items() if k not in acc}
    for k in acc:
        assert abs(got["summary"][k] - want[k]) <= 1e-4 + 1e-5
    assert got["accuracy_curve"][-1][2] > 0.7     # the README's "climbs"
    assert "mean round duration" in out


# --------------------------------------------------------------------- #
# (c) an LM federated through the engine, host and mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("execution", ["host", "mesh"])
def test_constellation_llm_matches_reference(examples, capsys, monkeypatch,
                                             execution):
    ref_mod, mine = examples["constellation_llm"]
    argv = ["--rounds", "2", "--max-steps", "2", "--execution", execution]
    (ref,) = _run_reference(ref_mod, argv, monkeypatch)
    ref_out = capsys.readouterr().out
    # The reference example's workload (gemma-2b reduced, seq 64, 32
    # samples a client), for the replayed init.
    jwl = jax_lm_workload(jax_get_config("gemma-2b").reduced(), seq_len=64,
                          samples_per_client=32)
    had_group = dist.is_initialized()
    try:
        got = mine.main(argv + ["--device", "cpu"],
                        sampler=JaxReplaySampler(0, workload=jwl))
    finally:
        # The mesh run makes a one-rank default group; later tests in this
        # process (the dry run's fake groups) need none.
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    assert ref.execution == got["execution"] == execution
    assert len(ref.rounds) == 2
    assert _records(got["rounds"]) == _records(ref.rounds)
    _assert_accuracy_close([r.accuracy for r in got["rounds"]],
                           [r.accuracy for r in ref.rounds])
    assert got["n_params"] == jwl.n_params
    assert got["model_bytes"] == jwl.model_bytes
    # The header and the execution line print the same; the round lines
    # carry the accuracy at 4 decimals.
    assert out.splitlines()[:2] == ref_out.splitlines()[:2]


# --------------------------------------------------------------------- #
# (d) batched prefill + decode
# --------------------------------------------------------------------- #
def _reference_tokens(cfg, params, batch: int, prompt_len: int,
                      tokens: int) -> np.ndarray:
    """The reference example's prefill and decode loop (`serve_llm.py`)."""
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size,
                                      (batch, prompt_len)), jnp.int32)
    max_seq = prompt_len + tokens + 8
    logits, cache = jax.jit(lambda p, t: jax_prefill(cfg, p, t, max_seq))(
        params, prompt)
    serve = jax.jit(jax_serve_step(cfg))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    outs = [tok]
    for _ in range(tokens):
        tok, _, cache = serve(params, tok, cache)
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_serve_llm_generates_the_reference_tokens(examples, capsys,
                                                  monkeypatch, arch):
    ref_mod, mine = examples["serve_llm"]
    cfg = jax_get_config(arch).reduced()
    params = jax.device_get(jax_init_params(cfg, jax.random.PRNGKey(0)))
    want = _reference_tokens(cfg, params, 4, 32, 4)
    monkeypatch.setattr(sys, "argv", [ref_mod.__file__, "--arch", arch,
                                      "--tokens", "4"])
    ref_mod.main()
    ref_out = capsys.readouterr().out
    got = mine.main(["--arch", arch, "--tokens", "4", "--device", "cpu"],
                    params=lm_params_from_jax(params, device="cpu"))
    out = capsys.readouterr().out
    assert got["tokens"].shape == (4, 5)
    np.testing.assert_array_equal(got["tokens"], want)
    # The header and both request lines print as the reference's do.
    keep = lambda text: [l for l in text.splitlines()
                         if l.startswith(("serving", "  request"))]
    assert keep(out) == keep(ref_out)
    assert len(keep(out)) == 3
