"""The benchmark's counts: model FLOPs against PyTorch's own FLOP
counter, the frozen kernel arithmetic, and the readers' silence where
there is nothing to read."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import harness
from bench.conftest import config_names
from bench.counts import kernels, model


def _no_flop_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """A stand-in for the attention kernel that does no matrix product
    but keeps every input in the graph."""
    rep = q.shape[1] // k.shape[1]
    keep = (q.sum(-1, keepdim=True)
            + k.repeat_interleave(rep, 1).sum(-1, keepdim=True)) * 0
    return v.repeat_interleave(rep, 1) + keep


def _no_flop_scan(r, k, v, logw, s0, *, chunk=64):
    keep = (r.sum(-1, keepdim=True) + k.sum(-1, keepdim=True)
            + logw.sum(-1, keepdim=True)) * 0
    return v + keep, s0 + 0


@pytest.mark.parametrize("name", config_names())
def test_matmul_flops_match_the_flop_counter(name, tiny, monkeypatch):
    cell = tiny(name, "float32")
    harness.program_path()
    from repro_torch.models.lm import attention, scan_core
    from repro_torch.models.lm.transformer import init_params
    from repro_torch.train.step import lm_loss
    monkeypatch.setattr(attention, "flash_attention_op", _no_flop_attention)
    monkeypatch.setattr(scan_core, "wkv6_op", _no_flop_scan)
    cfg = harness.port_config(cell.config)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [t.requires_grad_(True) for _, t in harness.tree_items(params)]
    rows, seq = cell.traffic["rows"], cell.traffic["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq))
    with FlopCounterMode(display=False) as counter:
        loss = lm_loss(cfg, params, {"tokens": tokens})[0]
        torch.autograd.grad(loss, leaves)
    want = model.step_flops(cell.config["model"], rows, seq)["matmul"]
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("segment", [{"kind": "moe", "n_layers": 1},
                                     {"kind": "attn", "n_layers": 1}])
def test_a_segment_kind_without_counts_is_refused(segment):
    model_cfg = dict(harness.load_json(
        harness.BENCH / "configs" / "hymba-1.5b.json")["model"],
        segments=[segment])
    with pytest.raises(ValueError, match="bench/counts/kinds"):
        model.step_flops(model_cfg, 1, 64)
    with pytest.raises(ValueError, match="bench/counts/kinds"):
        kernels.launches(model_cfg, 1, 64)


def test_a_feature_the_kind_does_not_count_is_refused():
    model_cfg = dict(harness.load_json(
        harness.BENCH / "configs" / "hymba-1.5b.json")["model"],
        mla={"q_lora_rank": 1536})
    with pytest.raises(ValueError, match="mla"):
        model.step_flops(model_cfg, 1, 64)


def test_flash_pairs_count_the_masked_pairs():
    for S, window in ((37, None), (64, 16), (50, 1), (10, 64)):
        q, k = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
        keep = k <= q
        if window:
            keep &= q - k < window
        assert kernels.flash_pairs(S, True, window) == int(keep.sum())


def test_kernel_names_map_to_their_kernels():
    assert kernels.family("void tc::flash_bf16_kernel<64, 64>(...)") \
        == "flash_attention"
    assert kernels.family("void flash_bwd_dkdv_tc<64, 64>(...)") \
        == "flash_attention_bwd"
    assert kernels.family("wkv6_chunk_kernel") == "wkv6"
    assert kernels.family("void wkv6_bwd_kernel<1>(...)") == "wkv6_bwd"
    assert kernels.family("ampere_bf16_s16816gemm") is None


@pytest.mark.parametrize("metric", [
    "flash_attention.roofline", "flash_attention_bwd.roofline",
    "wkv6.roofline", "wkv6_bwd.roofline", "device_idle_share"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    model_cfg = harness.load_json(
        harness.BENCH / "configs" / "rwkv6-1.6b.json")["model"]
    obs = {"trace": {"kernel_s": {"sm90_gemm": 1.0}, "busy_s": 0.0,
                     "window_s": 1.0},
           "launches": {}, "local_steps": 2,
           "launch_bounds": kernels.launches(model_cfg, 4, 2048)}
    assert harness.reader(metric).read(obs) is None


def test_roofline_share_of_a_measured_round():
    model_cfg = harness.load_json(
        harness.BENCH / "configs" / "hymba-1.5b.json")["model"]
    bounds = kernels.launches(model_cfg, 4, 2048)
    least = sum(bounds["flash_attention"]) * 2
    obs = {"trace": {"kernel_s": {"flash_bf16_kernel<64, 64>": least * 4}},
           "launches": {"flash_attention": 64}, "local_steps": 2,
           "launch_bounds": bounds}
    assert kernels.roofline_pct(obs, "flash_attention") == pytest.approx(25)
    obs["launches"]["flash_attention"] = 63          # a launch uncounted
    assert kernels.roofline_pct(obs, "flash_attention") is None
