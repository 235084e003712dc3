"""What the round adds to its local steps' model work (ms): the median
round wall of the traced run's window less local_steps times
`model_step_ms` (the copy of the weights, the proximal updates, the
delta, the masked aggregation and the dispatch between them), timed
from outside the round.

This holds only where the card paces the round. Where the host paces
it, a step timed alone waits for its own dispatch, which the round's
steps hide behind the card's work, and the difference falls below zero:
it then measures no driver work, and the reader returns nothing."""
import statistics


def read(obs: dict) -> float | None:
    walls, steps = obs.get("round_walls"), obs.get("model_step_s")
    if not walls or not steps:
        return None
    ms = 1e3 * (statistics.median(walls)
                - obs["local_steps"] * statistics.median(steps))
    return ms if ms > 0 else None
