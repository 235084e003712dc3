"""The port's dry-run analysis against the reference's: collective
kinds and bytes, the calibration algebra and probes, the roofline over
the H100's constants, the report's markdown, input shapes and the
analytic counts, for every LM architecture and input shape."""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.analysis import calibration as ref_calibration
from repro.analysis import report as ref_report
from repro.analysis import roofline as ref_roofline
from repro.analysis.collectives import (
    collective_bytes_by_kind as ref_collective_bytes,
)
from repro.analysis.collectives import count_collectives as ref_count
from repro.configs import get_config as ref_get_config
from repro.configs import lm_arch_ids
from repro.configs import shapes as ref_shapes
from repro.launch import mesh as ref_mesh
from repro_torch.analysis import calibration, report, roofline
from repro_torch.analysis.collectives import (
    collective_bytes_by_kind,
    count_collectives,
)
from repro_torch.configs import get_config
from repro_torch.configs import shapes
from repro_torch.launch import mesh

# The collectives of tests/test_analysis.py's HLO, as the dry run records
# them from DTensor: (op, ((dtype, output shape), ...)). HLO's
# collective-permute has no DTensor counterpart.
HLO = """
ENTRY main {
  %ag = bf16[16,2048]{1,0} all-gather(%x), replica_groups={{0,1}}
  %ar = (f32[8,8]{1,0}, f32[4]{0}) all-reduce(%a, %b), to_apply=%add
  %a2a = f32[2,4]{1,0} all-to-all(%y), dimensions={0}
  %rs = bf16[128]{0} reduce-scatter(%z), dimensions={0}
  %ags = (bf16[4]{0}, bf16[4]{0}) all-gather-start(%q)
  %agd = bf16[4]{0} all-gather-done(%ags)
  %dot = f32[4,4]{1,0} dot(%p, %q)
}
"""
RECORDS = [
    ("_c10d_functional::all_gather_into_tensor", (("bf16", (16, 2048)),)),
    ("_c10d_functional::wait_tensor", (("bf16", (16, 2048)),)),
    ("_c10d_functional::all_reduce_coalesced",
     (("f32", (8, 8)), ("f32", (4,)))),
    ("_c10d_functional::all_to_all_single", (("f32", (2, 4)),)),
    ("_c10d_functional::reduce_scatter_tensor", (("bf16", (128,)),)),
    ("_c10d_functional::all_gather_into_tensor_coalesced",
     (("bf16", (4,)), ("bf16", (4,)))),
    ("_c10d_functional::wait_tensor", (("bf16", (4,)),)),
    ("_c10d_functional::_wrap_tensor_autograd", (("bf16", (4,)),)),
]


def test_collective_bytes_match_reference_kinds():
    got = collective_bytes_by_kind(RECORDS)
    assert got == ref_collective_bytes(HLO)
    assert got["all-gather"] == 16 * 2048 * 2 + 2 * (4 * 2)
    assert got["all-reduce"] == 8 * 8 * 4 + 4 * 4
    assert got["all-to-all"] == 2 * 4 * 4
    assert got["reduce-scatter"] == 128 * 2


def test_waits_not_double_counted():
    assert count_collectives(RECORDS) == ref_count(HLO)
    assert count_collectives(RECORDS)["all-gather"] == 2


def test_dtensor_all_to_all_and_unknown_collectives():
    recs = [("_dtensor::shard_dim_alltoall", (("f32", (3, 5)),))]
    assert collective_bytes_by_kind(recs) == {"all-to-all": 60.0}
    with pytest.raises(KeyError, match="has no kind"):
        collective_bytes_by_kind([("_c10d_functional::broadcast",
                                   (("f32", (1,)),))])


def test_roofline_terms_over_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW,
            mesh.F32_FLOPS_PER_S) == (989e12, 3.35e12, 450e9, 67e12)
    r = {"chips": 256, "cost_flops": mesh.PEAK_FLOPS_BF16,
         "cost_bytes": 2 * mesh.HBM_BW,
         "collective_bytes": {"all-reduce": 3 * mesh.NVLINK_BW},
         "model_flops": mesh.PEAK_FLOPS_BF16 * 128}
    rf = roofline.roofline_terms(r)
    assert (rf["compute_s"], rf["memory_s"], rf["collective_s"]) == (
        1.0, 2.0, 3.0)
    assert rf["dominant"] == "collective"
    np.testing.assert_allclose(rf["useful_flops_ratio"], 0.5)
    # The reference's terms, rescaled from TPU v5e to H100 rates.
    r2 = {"chips": 512, "cost_flops": 3.1e15, "cost_bytes": 7.7e12,
          "collective_bytes": {"all-gather": 2e10, "all-to-all": 5e9},
          "model_flops": 9e17}
    want, got = ref_roofline.roofline_terms(r2), roofline.roofline_terms(r2)
    np.testing.assert_allclose(
        got["compute_s"],
        want["compute_s"] * ref_mesh.PEAK_FLOPS_BF16 / mesh.PEAK_FLOPS_BF16,
        rtol=1e-12)
    np.testing.assert_allclose(
        got["memory_s"], want["memory_s"] * ref_mesh.HBM_BW / mesh.HBM_BW,
        rtol=1e-12)
    np.testing.assert_allclose(
        got["collective_s"],
        want["collective_s"] * ref_mesh.ICI_BW / mesh.NVLINK_BW, rtol=1e-12)
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]


def test_calibration_metric_algebra():
    m1 = calibration.Metrics(10.0, 100.0, {"all-gather": 5.0})
    m2 = calibration.Metrics(14.0, 120.0, {"all-gather": 7.0,
                                           "all-reduce": 1.0})
    r1 = ref_calibration.Metrics(10.0, 100.0, {"all-gather": 5.0})
    r2 = ref_calibration.Metrics(14.0, 120.0, {"all-gather": 7.0,
                                               "all-reduce": 1.0})
    total = m1 + (m2 - m1).scaled(3.0)
    want = r1 + (r2 - r1).scaled(3.0)
    assert dataclasses.asdict(total) == dataclasses.asdict(want)
    assert total.flops == 10.0 + 3 * 4.0
    assert total.coll["all-reduce"] == 3.0


def test_probe_identity():
    m1 = calibration.Metrics(10, 100.0, {"all-gather": 5.0})
    m2 = calibration.Metrics(14, 120.0, {"all-gather": 7.0})
    e1 = calibration.Metrics(10, 100.0, {"all-gather": 5.0})
    e2 = calibration.Metrics(13, 100.0, {"all-gather": 5.0})
    # Two segments of 5 and 3 layers: 10 + 4*4 + 2*3 FLOPs.
    full = calibration.Metrics(32, 180.0, {"all-gather": 13.0})
    probes = [(m1, m2, 5), (e1, e2, 3)]
    assert calibration.probe_identity(full, probes)["ok"]
    off = calibration.Metrics(33, 180.0, {"all-gather": 13.0})
    assert not calibration.probe_identity(off, probes)["ok"]
    near = calibration.Metrics(32, 180.0 * (1 + 1e-7), {"all-gather": 13.0})
    assert calibration.probe_identity(near, probes)["ok"]
    far = calibration.Metrics(32, 180.0 * (1 + 1e-5), {"all-gather": 13.0})
    assert not calibration.probe_identity(far, probes)["ok"]


def _fields(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


@pytest.mark.parametrize("arch", lm_arch_ids())
def test_probe_configs_field_equal(arch):
    want = ref_calibration.probe_configs(ref_get_config(arch))
    got = calibration.probe_configs(get_config(arch))
    assert len(got) == len(want)
    for (i, c1, c2, n), (ri, r1, r2, rn) in zip(got, want):
        assert (i, n) == (ri, rn)
        assert _fields(c1) == _fields(r1)
        assert _fields(c2) == _fields(r2)


@pytest.mark.parametrize("arch", lm_arch_ids())
def test_counts_and_input_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert roofline.param_count(cfg) == ref_roofline.param_count(rcfg)
    assert roofline.active_param_count(cfg) == \
        ref_roofline.active_param_count(rcfg)
    assert shapes.INPUT_SHAPES.keys() == ref_shapes.INPUT_SHAPES.keys()
    assert shapes.LONGCTX_WINDOW == ref_shapes.LONGCTX_WINDOW
    for name, shape in shapes.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            ref_shapes.INPUT_SHAPES[name])
        assert roofline.model_flops(cfg, shape) == ref_roofline.model_flops(
            rcfg, ref_shapes.INPUT_SHAPES[name])
        got = shapes.input_specs(cfg, shape)
        want = ref_shapes.input_specs(rcfg, ref_shapes.INPUT_SHAPES[name])
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).removeprefix("torch.") == \
                jax.numpy.dtype(want[k].dtype).name, k
    c2, note = shapes.longctx_variant(cfg)
    r2, rnote = ref_shapes.longctx_variant(rcfg)
    assert note == rnote
    assert (c2 is None) == (r2 is None)
    if c2 is not None:
        assert _fields(c2) == _fields(r2)


def _results() -> list[dict]:
    return [
        {"arch": "yi-9b", "shape": "train_4k", "status": "ok", "note": "",
         "mesh": "16x16", "chips": 256, "compile_s": 12.3,
         "memory": {"argument_size_in_bytes": 3 << 30,
                    "output_size_in_bytes": 3 << 30},
         "roofline": {"compute_s": 2.5, "memory_s": 0.012,
                      "collective_s": 4.2e-5, "dominant": "compute",
                      "useful_flops_ratio": 0.734}},
        {"arch": "gemma-2b", "shape": "decode_32k", "status": "ok",
         "note": "beyond-paper SWA variant (window=8192)", "mesh": "16x16",
         "chips": 256, "compile_s": 1.0, "memory": {},
         "roofline": {"compute_s": 3e-7, "memory_s": 0.0021,
                      "collective_s": 0.0, "dominant": "memory",
                      "useful_flops_ratio": None}},
        {"arch": "whisper-medium", "shape": "long_500k", "status": "skipped",
         "note": "skip: enc-dec full-attention audio model; 500k-token "
                 "decode has no audio analogue (DESIGN.md)"},
        {"arch": "grok-1-314b", "shape": "train_4k", "status": "error",
         "error": "RuntimeError('Sharding propagation failed for aten.mm')"},
    ]


def test_report_markdown_equals_reference(tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_results()))
    got = report.roofline_markdown(str(path))
    assert got == ref_report.roofline_markdown(str(path))
    assert "**compute**" in got and "ERROR" in got and "skip" in got
    assert report.memory_markdown(str(path)) == \
        ref_report.memory_markdown(str(path))
    assert "3.00GiB" in report.memory_markdown(str(path))


def test_meta_tensors_cost_nothing():
    specs = shapes.input_specs(get_config("llava-next-mistral-7b"),
                               shapes.INPUT_SHAPES["train_4k"])
    assert specs["prefix_embeds"].dtype == torch.bfloat16
    assert all(t.device.type == "meta" for t in specs.values())
