"""Synthetic token streams for the assigned LM architectures' smoke tests.

Port of `repro.data.tokens` (numpy only, so the arrays are the
reference's bitwise).

Deterministic pseudo-language: a first-order Markov chain over a reduced
vocabulary, so reduced models can overfit a few steps and losses must
decrease — a real signal, not noise.

`federated_token_shards` packages per-satellite token streams into the
same `FederatedDataset` container the FEMNIST experiments use: each
client draws from its *own* Markov chain (distinct transition table), so
the shards are non-IID in exactly the writer-style sense — the structural
requirement for the LM fine-tuning workloads.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import FederatedDataset


def synthetic_token_batch(batch: int, seq_len: int, vocab: int,
                          seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Sparse Markov transitions: each token has 4 likely successors.
    succ = rng.integers(0, vocab, size=(vocab, 4))
    toks = np.empty((batch, seq_len), np.int32)
    state = rng.integers(0, vocab, size=(batch,))
    for t in range(seq_len):
        toks[:, t] = state
        pick = rng.integers(0, 4, size=(batch,))
        jump = rng.random(batch) < 0.1
        state = np.where(jump, rng.integers(0, vocab, size=(batch,)),
                         succ[state, pick])
    return toks


def federated_token_shards(n_clients: int, seed: int = 0, *,
                           seq_len: int = 32, samples_per_client: int = 32,
                           vocab: int = 128, eval_samples: int = 8
                           ) -> FederatedDataset:
    """Federated LM fine-tuning data: one Markov chain per satellite.

    x rows are (seq_len + 1) token windows — the workload's loss shifts
    them into (input, next-token target) pairs itself, so y carries no
    information (zeros) and exists only to satisfy the shared batch
    schema. All clients hold `samples_per_client` rows (n is uniform).
    """
    N = samples_per_client
    x = np.zeros((n_clients, N, seq_len + 1), np.int32)
    xe = np.zeros((n_clients, eval_samples, seq_len + 1), np.int32)
    for k in range(n_clients):
        # Distinct per-client chain: seed folds in the client index, so
        # shard k is the same for any constellation size (cache-friendly).
        toks = synthetic_token_batch(N + eval_samples, seq_len + 1, vocab,
                                     seed=seed * 100_003 + k)
        x[k] = toks[:N]
        xe[k] = toks[N:]
    return FederatedDataset(
        x=x, y=np.zeros((n_clients, N), np.int32),
        n=np.full((n_clients,), N, np.int32),
        x_eval=xe, y_eval=np.zeros((n_clients, eval_samples), np.int32),
        n_eval=np.full((n_clients,), eval_samples, np.int32),
    )
