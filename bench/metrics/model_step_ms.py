"""One local step's model work alone (ms): the program's `lm_loss` and
`torch.autograd.grad` on the round's own batch and weights, host clock
ending in a synchronise; the median of the traced run's repetitions."""
import statistics


def read(obs: dict) -> float | None:
    steps = obs.get("model_step_s")
    return 1e3 * statistics.median(steps) if steps else None
