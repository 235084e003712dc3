"""What a run prints and loads: the result line's keys, no module of the
JAX stack in the process, and no result without a CUDA device."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from bench import harness, run

CHILD = """
import json, sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from bench import harness, run
from bench.conftest import tiny_cell
for trace in (0, 1):
    line, _ = run.run_cell(tiny_cell({cell!r}, "float32"), 5, 0.0,
                           bool(trace), torch.device("cpu"), 0.0)
    print(json.dumps(line))
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax_and_prints_the_contract_keys():
    cell = harness.load_json(harness.ROOT / "BENCHMARK.json")[
        "workloads"][0]["name"]
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=str(harness.ROOT),
                                            cell=cell)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced, found = [json.loads(x)
                               for x in out.stdout.splitlines()[-3:]]
    assert found == []
    assert list(untraced) == ["correct", "attempted", "failed", "metrics",
                              "device", "checked"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checked"]
    assert set(untraced["metrics"]) == {"client_samples_per_s",
                                        "peak_mem_gib", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(untraced["device"])
    assert {"busy_s", "window_s"} <= set(traced["device"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in harness.forbidden_modules()


def test_no_result_without_a_cuda_device(capsys):
    if torch.cuda.is_available():
        return                         # the chip's own runs cover it
    cell = harness.load_json(harness.ROOT / "BENCHMARK.json")[
        "workloads"][0]["name"]
    rc = run.main(["--workload", cell, "--seed", str(2 ** 40),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
