"""Workload-agnostic federated data container.

One client == one satellite. Per-client shards are stacked along a
leading client axis and padded to a common sample count so the whole
dataset is a handful of dense arrays the vmapped ClientUpdate can index:

  x: (K, N, *sample_shape)  — whatever the workload's loss consumes
                              (28x28x1 images, (S+1,) token rows, ...);
  y: (K, N) int32           — labels (classification) or zeros when the
                              loss derives targets from x (LM next-token);
  n: (K,) int32             — valid-sample counts (rows past n[k] are pad);
  x_eval / y_eval / n_eval  — held-out shards with the same layout.

The batch schema (sample_shape + dtypes) is declared by the Workload; the
engine never inspects it — it only slices client rows and hands them to
the workload's loss/eval functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FederatedDataset:
    """Stacked per-client arrays, padded to a common sample count."""

    x: np.ndarray
    y: np.ndarray
    n: np.ndarray
    x_eval: np.ndarray
    y_eval: np.ndarray
    n_eval: np.ndarray

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    @property
    def sample_shape(self) -> tuple[int, ...]:
        """Trailing per-sample feature shape (the batch schema's x part)."""
        return tuple(self.x.shape[2:])
