"""Sparse-participation edge variants (arXiv 2401.15541 style).

Satellite edge-learning studies show FL converging with far fewer
participants per round than the contact schedule could serve — valuable
in orbit, where every selected satellite costs downlink passes and
onboard energy. `Strategy.participation` scales the engine's nominal
selection budget (`Strategy.round_size`); this module is the one-line
way to derive such a variant from any registered strategy.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategies.base import Strategy


def sparse_variant(strategy: Strategy, participation: float,
                   name: str | None = None) -> Strategy:
    """`strategy` with only a `participation` fraction of the nominal
    selection budget actually enrolled per round (floored at one
    satellite). The returned strategy keeps the base aggregation and
    scheduling hooks, so it drops into every execution path the base
    strategy supports."""
    return dataclasses.replace(
        strategy, participation=float(participation),
        name=name or f"{strategy.name}_sparse")
