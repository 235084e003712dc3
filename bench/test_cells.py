"""Every cell of BENCHMARK.json loads from its own files, and the file
keeps the benchmark's contract."""
from __future__ import annotations

import re

import pytest
import torch

from bench import harness, weights
from bench.conftest import cell_names, config_names

BENCHMARK = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", cell_names())
def test_cell_loads_from_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips in (1, 4)
    assert callable(cell.driver.run) and callable(cell.reference.loss_sum)
    harness.port_config(cell.config)        # raises unless the program's
    for spec in cell.per_layer:
        assert callable(harness.reader(spec["name"]).read)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    assert cell.limits
    for spec in cell.limits.values():
        assert spec["lower"] < spec["limit"] < spec["upper"]


def test_benchmark_keeps_the_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert c["reduced"] == harness.load_json(
            harness.ROOT / c["file"])["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells and "\n" not in m["layer"]
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("config", config_names())
def test_weights_follow_the_init_table(config, tiny):
    cell = tiny(config)
    harness.program_path()
    from repro_torch.models.lm.transformer import init_params
    layout = init_params(harness.port_config(cell.config), None, "meta")
    init = cell.config["init"]
    leaf_names = {p.rsplit("/", 1)[-1] for p, _ in harness.tree_items(layout)}
    assert set(init) - {"default"} <= leaf_names
    make = lambda seed: weights.make(layout, init, seed, "cpu",
                                     torch.bfloat16)
    a, b, c = make(2 ** 40 + 1), make(2 ** 40 + 1), make(2 ** 40 + 2)
    for (p, x), (_, y), (_, z), (_, m) in zip(
            *map(harness.tree_items, (a, b, c, layout))):
        assert x.shape == m.shape and x.dtype == torch.bfloat16
        assert torch.equal(x, y)
        spec = init.get(p.rsplit("/", 1)[-1], init["default"])
        if "normal" in spec or "trunc_normal" in spec:
            assert not torch.equal(x, z)


@pytest.mark.parametrize("config", config_names())
def test_config_files_are_the_programs_sizes(config):
    cfg = harness.load_json(harness.BENCH / "configs" / f"{config}.json")
    assert cfg["name"] == config
    assert set(cfg["reduced"]) <= set(cfg["model"])
    assert (harness.ROOT / cfg["reference"]).exists()
    harness.port_config(cfg)                # raises unless the program's


def test_a_size_differs_from_the_program_only_where_reduced_says():
    cfg = harness.load_json(harness.BENCH / "configs" / "hymba-1.5b.json")
    cfg["model"].update(n_layers=2,
                        segments=[{"kind": "hybrid", "n_layers": 2}])
    with pytest.raises(ValueError, match="reduced"):
        harness.port_config(cfg)
    cfg["reduced"] = ["n_layers", "segments"]
    assert harness.port_config(cfg).n_layers == 2
