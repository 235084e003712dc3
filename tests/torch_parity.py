"""Shared helpers for the `repro_torch` parity tests (not a test module).

`JaxReplaySampler` is a sampler for the port's `ConstellationSim` that
replays the reference engine's random draws: the init key split of
`repro/sim/engine.py` (`_run_events`), one split per training round
(`_sync_feed` / `_async_feed`), the per-client split of `_run_clients`,
and the per-step `split` + `randint` of `repro/core/client.py`. Fed the
same access windows and data, the two engines then train on identical
minibatches.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.femnist_mlp import femnist_mlp_init
from repro_torch.params import params_from_jax


@functools.partial(jax.jit, static_argnames=("bound", "batch_size"))
def _draw(rngs, n_valid, *, bound: int, batch_size: int):
    """(C, bound, B) indices exactly as the reference's vmapped client
    loop draws them (`client.py`: split, then randint in [0, max(n, 1)))."""

    def one(rng, n):
        def body(rng, _):
            rng, sub = jax.random.split(rng)
            idx = jax.random.randint(sub, (batch_size,), 0,
                                     jnp.maximum(n, 1))
            return rng, idx

        return jax.lax.scan(body, rng, None, length=bound)[1]

    return jax.vmap(one)(rngs, n_valid)


def replay_indices(rngs, n_valid, bound: int, batch_size: int) -> np.ndarray:
    """Reference minibatch indices for per-client keys `rngs`."""
    return np.array(_draw(rngs, jnp.asarray(n_valid, jnp.int32),
                            bound=bound, batch_size=batch_size))


class JaxReplaySampler:
    """Replays the reference engine's PRNG stream for the port's engine."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.rng = jax.random.PRNGKey(seed)
        self.device = torch.device(device)

    def init(self, workload) -> torch.Tensor:
        self.rng, init_rng = jax.random.split(self.rng)
        tree = jax.device_get(femnist_mlp_init(init_rng))
        return params_from_jax(tree, workload.layout, device=self.device)

    def minibatches(self, n_valid, bound: int, batch_size: int):
        self.rng, sub = jax.random.split(self.rng)
        rngs = jax.random.split(sub, len(n_valid))
        idx = replay_indices(rngs, n_valid, bound, batch_size)
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)


def jax_init_params(seed: int = 0) -> dict:
    """The reference engine's initial params for `SimConfig(seed=seed)`."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    return jax.device_get(femnist_mlp_init(init_rng))
