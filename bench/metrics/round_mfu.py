"""The round's model FLOPs (`bench.counts.model`: its local steps' matmul,
attention and scan work) over the median round wall of the traced run's
window times the H100's dense bf16 peak (`bench/counts/peaks.json`), in
%."""
import statistics

from bench.counts import kernels


def read(obs: dict) -> float | None:
    walls = obs.get("round_walls")
    if not walls:
        return None
    flops = obs["local_steps"] * obs["step_flops"]
    return 100.0 * flops / (statistics.median(walls)
                            * kernels.PEAKS["bf16_flops_per_s"])
