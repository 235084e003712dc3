"""Shared helpers for the `repro_torch` parity tests (not a test module).

`JaxReplaySampler` is a sampler for the port's `ConstellationSim` that
replays the reference engine's random draws: the init key split of
`repro/sim/engine.py` (`_run_events`), one split per training round
(`_sync_feed` / `_async_feed`), the per-client split of `_run_clients`,
and the per-step `split` + `randint` of `repro/core/client.py`; and the
codec's stochastic-rounding draws of `_train_round` (each client key
folded with `CODEC_RNG_TAG`, split per leaf, one uniform per element).
Fed the same access windows and data, the two engines then train on
identical minibatches and round on identical uniforms.

`assert_same_plan` holds a port `ContactPlan` to a reference one bitwise.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.comms.codec import CODEC_RNG_TAG
from repro.core.workload import get_workload as jax_get_workload
from repro_torch.params import params_from_jax


# The suite runs in several worker processes at once (pytest-xdist), and
# each torch CPU op would start a thread per core in each of them: the
# threads then contend for the same cores and the parity tests run many
# times slower. One torch thread a worker keeps them apart.
torch.set_num_threads(1)


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


@functools.partial(jax.jit, static_argnames=("shapes",))
def _codec_draw(rngs, *, shapes):
    """(C, P) uniforms exactly as the reference's codec draws them
    (`codec.py` `TransferCodec.apply`: fold_in the tag, split per leaf,
    `uniform(key, leaf.shape, f32)`), leaves flattened in layout order."""

    def one(rng):
        keys = jax.random.split(jax.random.fold_in(rng, CODEC_RNG_TAG),
                                len(shapes))
        return jnp.concatenate([
            jax.random.uniform(k, shape, jnp.float32).reshape(-1)
            for k, shape in zip(keys, shapes)])

    return jax.vmap(one)(rngs)


def replay_codec_uniforms(rngs, layout) -> np.ndarray:
    """Reference codec uniforms for per-client keys `rngs` over the leaves
    of `layout` (a `repro_torch.params.ParamLayout`)."""
    shapes = tuple(tuple(shape) for _, shape in layout.leaves)
    return np.array(_codec_draw(rngs, shapes=shapes))


def replay_indices(rngs, n_valid, bound: int, batch_size: int) -> np.ndarray:
    """Reference minibatch indices for per-client keys `rngs`."""
    return np.array(_draw(rngs, jnp.asarray(n_valid, jnp.int32),
                            bound=bound, batch_size=batch_size))


class JaxReplaySampler:
    """Replays the reference engine's PRNG stream for the port's engine."""

    def __init__(self, seed: int = 0, device="cpu", workload=None):
        self.rng = jax.random.PRNGKey(seed)
        self.device = torch.device(device)
        self.workload = workload   # a reference Workload outside the registry

    def init(self, workload) -> torch.Tensor:
        """The reference's init of the workload of the same name (or of
        the reference workload this sampler was given)."""
        self.rng, init_rng = jax.random.split(self.rng)
        ref = self.workload or jax_get_workload(workload.name)
        tree = jax.device_get(ref.init_fn(init_rng))
        return params_from_jax(tree, workload.layout, device=self.device)

    def minibatches(self, n_valid, bound: int, batch_size: int):
        self.rng, sub = jax.random.split(self.rng)
        rngs = jax.random.split(sub, len(n_valid))
        self.client_rngs = rngs        # the codec draws from the same keys
        idx = replay_indices(rngs, n_valid, bound, batch_size)
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)

    def codec_uniforms(self, n_clients: int, layout) -> torch.Tensor:
        assert len(self.client_rngs) == n_clients
        u = replay_codec_uniforms(self.client_rngs, layout)
        return torch.as_tensor(u, device=self.device)


def jax_init_params(seed: int = 0, workload: str = "femnist_mlp") -> dict:
    """The reference engine's initial params for `SimConfig(seed=seed)`
    on `workload`."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    return jax.device_get(jax_get_workload(workload).init_fn(init_rng))


EDGE_FIELDS = ("starts", "ends", "rates", "mid_range_m", "range_profile",
               "rate_profile", "cummax_ends")


def same_edge(a, b) -> bool:
    """Two `_EdgeWindows` hold the same arrays, dtypes included."""
    for f in EDGE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and not (np.array_equal(x, y)
                                  and np.asarray(x).dtype
                                  == np.asarray(y).dtype):
            return False
    return True


def same_table(a, b) -> bool:
    """Two `WindowTable`s hold the same arrays."""
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               if getattr(a, f) is not None else getattr(b, f) is None
               for f in ("starts", "ends", "rates", "counts", "cummax_ends",
                         "rate_profile", "_profile_times"))


def assert_same_plan(mine, ref):
    """Two `ContactPlan`s (one per package) agree bitwise: per-edge window
    arrays, geometry caches, neighbours and the padded tables."""
    assert (mine.n_sats, mine.horizon_s) == (ref.n_sats, ref.horizon_s)
    assert mine.neighbors == ref.neighbors
    assert len(mine.ground) == len(ref.ground)
    assert all(same_edge(a, b) for a, b in zip(mine.ground, ref.ground))
    assert list(mine.isl) == list(ref.isl)
    assert all(same_edge(mine.isl[e], ref.isl[e]) for e in ref.isl)
    mt, rt = mine.tables(), ref.tables()
    assert same_table(mt.ground, rt.ground)
    assert same_table(mt.isl, rt.isl)
    assert mt.edge_index == rt.edge_index
    for f in ("adj_src", "adj_dst", "adj_edge", "seg_starts", "seg_dst",
              "out_order", "out_starts"):
        assert np.array_equal(getattr(mt, f), getattr(rt, f)), f
