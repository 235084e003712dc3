"""The port stands alone: no `jax`, nothing of `repro`, CUDA by default."""
from __future__ import annotations

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(_modules()) >= 30
    assert {"repro_torch.models.lm.rwkv", "repro_torch.models.lm.moe",
            "repro_torch.models.lm.mla",
            "repro_torch.obs.export", "repro_torch.launch.dryrun",
            "repro_torch.launch.mesh", "repro_torch.configs.shapes",
            "repro_torch.sharding.specs", "repro_torch.analysis.calibration",
            "repro_torch.analysis.collectives", "repro_torch.analysis.report",
            "repro_torch.analysis.roofline"} <= set(_modules())


def test_every_reference_module_has_a_counterpart():
    """The port's tree holds every module path of the reference's."""
    def tree(pkg):
        root = os.path.join(SRC, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}
    assert tree("repro") - tree("repro_torch") == set()


# Public names of the reference with no counterpart of the same name in
# the port's module of the same path, each with its reason or the name
# that takes its place.
NAME_EXCEPTIONS = {
    "sharding/compat.py": {
        "shard_map": "DTensor and local tensors take its place "
                     "(`apply_moe_ep_mesh`, `make_mesh_round_step`)"},
    "analysis/calibration.py": {
        "metrics_from_compiled": "reads XLA's cost analysis of a compiled "
                                 "program; the port counts with `CostMode`"},
    "core/aggregation.py": {"Pytree": "a typing alias for JAX pytrees"},
    "core/strategies/base.py": {"Pytree": "a typing alias for JAX pytrees"},
    "models/lm/transformer.py": {"Pytree": "a typing alias for JAX pytrees"},
    "kernels/prox_sgd.py": {"BLOCK": "a Pallas tiling constant"},
    "kernels/fedagg.py": {"BLOCK_P": "a Pallas tiling constant"},
    "kernels/flash_attention.py": {
        "DEFAULT_BQ": "a Pallas tiling constant (the CUDA tiles are fixed)",
        "DEFAULT_BK": "a Pallas tiling constant (the CUDA tiles are fixed)",
        "NEG_INF": "the Pallas kernel's mask value; the CUDA kernels mask "
                   "in their own code"},
    "launch/mesh.py": {"ICI_BW": "the TPU interconnect's rate; its "
                                 "counterpart is `NVLINK_BW`"},
}


def _public_names(path: str, attributes: bool
                  ) -> tuple[set[str], dict[str, set[str]]]:
    """Top-level public names of a module (functions, classes and
    assigned names) and, per public class, its public methods (with its
    class attributes and fields if `attributes`), by AST."""
    with open(path) as f:
        tree = ast.parse(f.read())

    def targets(node) -> list[str]:
        if isinstance(node, ast.Assign):
            nodes = node.targets
        elif isinstance(node, ast.AnnAssign):
            nodes = [node.target]
        else:
            return []
        out = []
        for t in nodes:
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if isinstance(e, ast.Name):
                    out.append(e.id)
        return out

    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    top, members = set(), {}
    for node in tree.body:
        names = [node.name] if isinstance(node, defs) else targets(node)
        top |= {n for n in names if not n.startswith("_")}
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            members[node.name] = {
                n for m in node.body
                for n in ([m.name] if isinstance(m, defs)
                          else targets(m) if attributes else [])
                if not n.startswith("_")}
    return top, members


def _module_paths(pkg: str) -> list[str]:
    root = os.path.join(SRC, pkg)
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".py"))


def test_every_reference_public_name_has_a_counterpart():
    """Module by module, every public top-level name of the reference and
    every public method of its public classes has a counterpart of the
    same name in the port (a method may be a class attribute there), but
    for the JAX- and TPU-only names of `NAME_EXCEPTIONS`."""
    missing, stale = [], []
    for rel in _module_paths("repro"):
        ref_top, ref_members = _public_names(
            os.path.join(SRC, "repro", rel), attributes=False)
        top, members = _public_names(
            os.path.join(SRC, "repro_torch", rel), attributes=True)
        allowed = NAME_EXCEPTIONS.get(rel, {})
        missing += [f"{rel}:{n}" for n in sorted(ref_top - top - set(allowed))]
        stale += [f"{rel}:{n}" for n in sorted(set(allowed) - ref_top)]
        stale += [f"{rel}:{n}" for n in sorted(set(allowed) & top)]
        for cls, names in sorted(ref_members.items()):
            if cls in members:
                missing += [f"{rel}:{cls}.{n}"
                            for n in sorted(names - members[cls])]
    assert not missing, f"reference names without a counterpart: {missing}"
    # An exception names a reference name that the port really lacks.
    assert not stale, f"exceptions that no longer apply: {stale}"
    assert set(NAME_EXCEPTIONS) <= set(_module_paths("repro"))


_FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b|"
                        r"import repro\.|from repro\.|from repro import)",
                        re.MULTILINE)


def _sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    examples = os.path.join(ROOT, "examples", "torch")
    out += [os.path.join(examples, f) for f in os.listdir(examples)
            if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_never_imports_jax_or_repro(path):
    with open(path) as f:
        text = f.read()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{path} imports {hits}"


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # `meta` is the dry run's shapes-only device (jax.eval_shape's
    # counterpart); any other device still raises.
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")


def test_femnist_mlp_init_defaults_to_cuda(monkeypatch):
    """Like every entry point, the femnist init resolves device=None to
    the card, and raises without one rather than running on the CPU."""
    from repro_torch.models.femnist_mlp import femnist_mlp_init
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        femnist_mlp_init(torch.Generator().manual_seed(0))
    assert femnist_mlp_init(torch.Generator().manual_seed(0),
                            "cpu").device == torch.device("cpu")


def test_lm_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import get_workload
    from repro_torch.launch import serve, train
    from repro_torch.models.lm.attention import cache_positions
    from repro_torch.models.lm.layers import dense_init, init_mlp, rope_freqs
    from repro_torch.models.lm.moe import init_moe
    from repro_torch.models.lm.params import lm_params_from_jax
    from repro_torch.models.lm.rwkv import init_rwkv_channel_mix, \
        init_rwkv_time_mix
    from repro_torch.models.lm.ssm import init_ssm
    from repro_torch.models.lm.transformer import init_params
    from repro_torch.params import params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("hymba-1.5b").reduced()
    gen = torch.Generator()
    for call in (lambda: init_params(cfg, gen),
                 lambda: dense_init(gen, (4, 8)),
                 lambda: init_mlp(gen, 4, 8, True),
                 lambda: init_ssm(gen, cfg.d_model, cfg.ssm),
                 lambda: init_rwkv_time_mix(gen, 128, 64),
                 lambda: init_rwkv_channel_mix(gen, 128, 256),
                 lambda: init_moe(gen, 64, get_config("grok-1-314b")
                                  .reduced().moe, "gelu"),
                 lambda: rope_freqs(8, 1e4),
                 lambda: cache_positions(3, 4, 2),
                 lambda: lm_params_from_jax({}),
                 lambda: params_from_jax({}),
                 lambda: serve.main(["--arch", "gemma-2b"]),
                 lambda: train.main(["--arch", "hymba-1.5b", "--steps", "1"]),
                 lambda: get_workload("lm_tiny").init_fn(gen, None),
                 lambda: get_workload("lm_hybrid_tiny").init_fn(gen, None),
                 lambda: get_workload("lm_rwkv6_tiny").init_fn(gen, None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
