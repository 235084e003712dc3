"""The dry run on a (2, 2) mesh of DTensors over a fake process group,
each test in a spawned process (the dry run owns its process: it makes
the group): the pure-DP regime splits the FLOPs exactly four ways and
gathers the sharded weights once, the FSDP + TP regime does no less work
than one device, the count is the 1-layer probe plus (L - 1) bodies, a
process's group of another size is refused, and the CLI runs a pair on
the 2 x 16 x 16 mesh."""
from __future__ import annotations

import json
import multiprocessing as mp
import os

import torch

from repro_torch.analysis.calibration import probe_configs, probe_identity
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm.params import map_tree
from repro_torch.models.lm.transformer import init_params
from repro_torch.sharding.compat import abstract_mesh
from repro_torch.sharding.specs import param_pspecs
from test_torch_dryrun import SHAPES, _cfg

SPAWN_TIMEOUT_S = 120.0


def _run(fn, args, conn):
    # A lower priority, as `torch_mesh_ranks` gives its ranks: the suite's
    # other workers, some timing threads, share the machine.
    os.nice(10)
    try:
        conn.send(("ok", fn(*args)))
    except BaseException as e:  # noqa: BLE001 — sent back to the test
        conn.send(("error", repr(e)))


def _spawned(fn, *args, timeout: float = SPAWN_TIMEOUT_S):
    """fn(*args) in a spawned process (its own fake process group)."""
    mpc = mp.get_context("spawn")
    parent, child = mpc.Pipe(duplex=False)
    proc = mpc.Process(target=_run, args=(fn, args, child))
    proc.start()
    try:
        if not parent.poll(timeout):
            raise TimeoutError(f"{fn.__name__} still running after "
                               f"{timeout} s")
        status, out = parent.recv()
    finally:
        if proc.is_alive():
            proc.kill()
        proc.join(10)
    assert status == "ok", out
    return out


def _mesh22(kinds, arch, n_layers, force_small):
    """On a (2, 2) mesh: per kind, the count on the mesh, the count on one
    device, the probe identity, and the bytes of the param leaves the
    pure-DP regime shards."""
    from repro_torch.sharding.compat import device_mesh

    torch.set_num_threads(1)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    dmesh = device_mesh(mesh)
    cfg = _cfg(arch, n_layers)
    out = {}
    for kind in kinds:
        shape = SHAPES[kind]
        m, _ = dryrun.run_step(cfg, shape, mesh, dmesh,
                               force_small=force_small)
        one, _ = dryrun.run_step(cfg, shape, make_host_mesh(), None,
                                 force_small=force_small)
        probes = [(dryrun.run_step(c1, shape, mesh, dmesh,
                                   force_small=force_small)[0],
                   dryrun.run_step(c2, shape, mesh, dmesh,
                                   force_small=force_small)[0], n)
                  for _, c1, c2, n in probe_configs(cfg)]
        params = init_params(cfg, torch.Generator().manual_seed(0), "meta")
        specs = param_pspecs(params, mesh, allow_tp_only=True)
        sharded = []
        map_tree(lambda t, s: sharded.append(t.numel() * t.element_size())
                 if any(e is not None for e in s) else None, params, specs)
        out[kind] = {"flops": m.flops, "one": one.flops, "coll": m.coll,
                     "identity": probe_identity(m, probes),
                     "sharded_bytes": sum(sharded)}
    try:
        device_mesh(abstract_mesh((8,), ("data",)))
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
    return out


def test_pure_dp_mesh_splits_flops_four_ways():
    out = _spawned(_mesh22, ("train",), "hymba-1.5b", 3, True)
    train = out["train"]
    assert train["flops"] * 4 == train["one"] > 0
    # Replicated in the step: every sharded weight gathered once.
    assert train["coll"]["all-gather"] == train["sharded_bytes"] > 0
    assert train["identity"]["ok"], train["identity"]
    assert "fake group of its own" in out["refused"]


def test_fsdp_tp_mesh_does_no_less_work():
    out = _spawned(_mesh22, ("prefill", "decode"), "qwen1.5-4b", 3, False)
    for kind in ("prefill", "decode"):
        assert out[kind]["flops"] * 4 >= out[kind]["one"] > 0
        assert out[kind]["identity"]["ok"], (kind, out[kind]["identity"])
        assert sum(out[kind]["coll"].values()) > 0


def _cli(argv):
    from repro_torch.launch.dryrun import main

    return main(argv)


def test_cli_multi_pod_pair(tmp_path):
    path = str(tmp_path / "dryrun.json")
    rc = _spawned(_cli, ["--arch", "gemma-2b", "--shape", "long_500k",
                         "--multi-pod", "--no-calibrate", "--out", path])
    assert rc == 0
    (r,) = json.load(open(path))
    assert (r["status"], r["mesh"], r["chips"]) == ("ok", "2x16x16", 512)
    assert r["calibration"] == "unchecked (--no-calibrate)"
