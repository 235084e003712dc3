"""The readers of rwkv6-1.6b's cell: they read nothing where the trace or
the program's counter has nothing for them, and `wkv6`'s share counts
the launches that the program made, recomputed layers' included."""
from __future__ import annotations

import pytest

from bench import harness
from bench.counts import kernels

CONFIG = harness.load_json(harness.BENCH / "configs" / "rwkv6-1.6b.json")


def _obs(kernel_s: dict, launches: dict, busy_s: float = 1.0) -> dict:
    return {"trace": {"kernel_s": kernel_s, "busy_s": busy_s,
                      "window_s": 2.0},
            "launches": launches, "local_steps": 2, "round_walls": [],
            "launch_bounds": kernels.launches(CONFIG["model"], 4, 2048)}


@pytest.mark.parametrize("metric", [
    "rwkv6.wkv6.roofline", "rwkv6.wkv6_bwd.roofline",
    "rwkv6.round_mfu", "rwkv6.device_idle_share"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    obs = _obs({"sm90_gemm": 1.0}, {}, busy_s=0.0)
    assert harness.reader(metric).read(obs) is None


@pytest.mark.parametrize("launches", [48, 60])
def test_wkv6_share_counts_the_launches_made(launches):
    obs = _obs({}, {"wkv6": launches})
    least = obs["launch_bounds"]["wkv6"][0]
    assert len(obs["launch_bounds"]["wkv6"]) == 24
    obs["trace"]["kernel_s"]["wkv6_chunk_kernel<64, 64>"] = \
        least * launches * 5
    read = harness.reader("rwkv6.wkv6.roofline").read
    assert read(obs) == pytest.approx(20)
    obs["launches"]["wkv6"] = 47                    # a launch uncounted
    assert read(obs) is None
