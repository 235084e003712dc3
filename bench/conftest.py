"""CPU test support for the benchmark: each cell at a tiny size.

Each configuration file's "tiny" section gives its tiny copy's sizes,
which keep its kinds of layer, head size and state sizes and cut the
width, depth, vocabulary and window; the mix keeps its local steps and
check rounds on 2 rows of 64 tokens (1 row for a one-row mix). The
program runs its kernels' plain versions on the CPU.
"""
from __future__ import annotations

import pytest
import torch

from bench import harness


def tiny_cell(name: str, dtype: str | None = None,
              traffic: str | None = None) -> harness.Cell:
    """`name`'s cell at the tiny size, in `dtype` (the configuration's
    parameter type unless given), with the mix `traffic`
    (`bench/traffic/<traffic>.json`) in place of its own if given. A
    configuration's name with no cell of its own
    (`bench/configs/<name>.json`) gets the first cell's mix."""
    if name in cell_names():
        cell = harness.load_cell(name)
    else:
        cell = harness.load_cell(cell_names()[0])
        cell.config = harness.load_json(harness.BENCH / "configs"
                                        / f"{name}.json")
        cell.limits = {}
    if traffic:
        cell.traffic = harness.load_json(harness.BENCH / "traffic"
                                         / f"{traffic}.json")
    cfg = cell.config
    cfg["model"].update({k: v for k, v in cfg["tiny"].items()
                         if not k.startswith("_")})
    cfg["test_size"] = True
    if dtype:
        cfg["param_dtype"] = cfg["model"]["dtype"] = dtype
    cell.traffic.update(rows=min(cell.traffic["rows"], 2), seq=64)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs beside other workers,
    and these models are too small to gain from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cell_names() -> list[str]:
    return [w["name"] for w in
            harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def traffic_names() -> list[str]:
    """Every traffic mix of the benchmark, with a cell or not."""
    return sorted(p.stem for p in (harness.BENCH / "traffic").glob("*.json"))


def config_names() -> list[str]:
    """Every configuration file of the benchmark, with a cell or not."""
    return sorted(p.stem for p in (harness.BENCH / "configs").glob("*.json"))
