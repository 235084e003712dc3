"""The benchmark's general machinery, driven by `BENCHMARK.json` and the
files it names.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration is `bench/configs/<config>.json` (the sizes as they are
run, their source and the weights' initial distributions) with its plain
reference beside it in `bench/reference/<config>.py`; the mix is
`bench/traffic/<traffic>.json`, whose `driver` names the module of
`bench/drivers/` that runs it; each per-layer metric is read by
`bench/metrics/<metric>.py`; each cell's correctness limits are in
`bench/limits/<cell>.json`. So a cell, a configuration or a metric is
added by adding files and entries, without an edit here.

Nothing here imports the program at module level: the program's package
is put on `sys.path` by `program_path()` and imported by the drivers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# Top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package the program was ported from. Compared whole,
# so that the port's own `repro_torch` passes.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def program_path() -> None:
    """Put the program's package directory (`src/`) first on sys.path."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN_MODULES)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark, by path (its names carry dots and
    dashes, so they are not importable by name)."""
    name = "bench_file_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one purpose (`tag`) of a run's seed:
    any whole number, of any size, gives a valid one."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Cell:
    """One `workloads` entry with everything its files say."""

    name: str
    chips: int
    config: dict          # bench/configs/<config>.json
    traffic: dict         # bench/traffic/<traffic>.json
    limits: dict          # bench/limits/<cell>.json ({} when absent)
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def driver(self) -> ModuleType:
        return load_module(BENCH / "drivers" / f"{self.traffic['driver']}.py")

    @property
    def reference(self) -> ModuleType:
        return load_module(ROOT / self.config["reference"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    bench = benchmark or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = {k: v for k, v in (load_json(limits_file).items()
                                if limits_file.exists() else ())
              if not k.startswith("_")}
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def reader(metric: str) -> ModuleType:
    """The per-layer metric's reader, `bench/metrics/<metric>.py`."""
    return load_module(BENCH / "metrics" / f"{metric}.py")


# ------------------------------------------------------------------ trees
def tree_items(tree, prefix: str = "") -> list:
    """(path, leaf) of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ------------------------------------------------------------ the program
def port_config(config: dict):
    """The program's `ModelConfig` of a configuration file: its registry
    entry with the file's "model" section applied, so that a smaller copy
    of the file (the tests') gives the program the same smaller model.
    Raises if the file's sizes differ from the registry's in a key that
    its `reduced` list does not name."""
    program_path()
    from repro_torch.configs import get_config
    from repro_torch.models.lm.config import Segment, SSMConfig

    registry = get_config(config["registry"])
    base = dataclasses.replace(registry, segments=registry.resolved_segments)
    model = dict(config["model"])
    model["segments"] = tuple(Segment(**s) for s in model["segments"])
    if "ssm" in model:
        model["ssm"] = SSMConfig(**model["ssm"])
    cfg = dataclasses.replace(base, **model)
    cut = {k: getattr(cfg, k) for k in config["reduced"]}
    if not config.get("test_size") and \
            cfg != dataclasses.replace(base, **cut):
        raise ValueError(f"{config['name']}: the configuration file's sizes "
                         f"differ from the program's {config['registry']!r} "
                         f"in a key that `reduced` does not list")
    return cfg
