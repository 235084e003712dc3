"""Workload abstraction — what the constellation actually trains.

Port of `repro.core.workload`. A `Workload` carries:

  * `init_fn(generator, device) -> flat params` and
    `loss_fn(views, xb, yb) -> per-client losses` — the model and its
    per-batch data loss over the flat parameter `layout` (the proximal
    term is the `prox_sgd` kernel's, in `repro_torch.core.client`);
  * `eval_fn(params, x, y, n_valid) -> 0-d tensor` — weighted metric over
    stacked eval clients;
  * a batch schema (`sample_shape`, `sample_dtype`) plus
    `make_data(n_clients, seed) -> FederatedDataset`;
  * a cost model: `model_bytes` and `epoch_mflops` derived from the
    parameter layout, unless pinned.

Two workloads are ported: `femnist_mlp`, the paper's sweep model, whose
cost numbers are pinned to the paper's section-5 constants (so
`HardwareModel.for_workload("femnist_mlp") == HardwareModel()`), and
`femnist_cnn`, the paper's headline 47k-parameter CNN, whose cost is
derived from its conv/dense dims. The reference's LM workloads come in a
later slice (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.core.client import classification_loss, evaluate
from repro_torch.data.femnist import IMG, synth_femnist
from repro_torch.orbits import constants as C
from repro_torch.params import FEMNIST_CNN, FEMNIST_MLP, ParamLayout

EXECUTION_MODES = ("host", "mesh")

# Reference workloads still to port, with the ROADMAP item that brings each.
_NOT_PORTED = {
    "lm_tiny": "ROADMAP LM training slice",
    "lm_moe_tiny": "ROADMAP LM training slice",
    "lm_rwkv6_tiny": "ROADMAP LM training slice",
    "lm_hybrid_tiny": "ROADMAP LM training slice",
}


def validate_execution(execution: str) -> str:
    """The one validator for execution modes (`Workload.with_execution`
    and `ConstellationSim` both route here)."""
    if execution not in EXECUTION_MODES:
        raise ValueError(f"unknown execution mode {execution!r}; "
                         f"expected one of {EXECUTION_MODES}")
    return execution


@dataclasses.dataclass(frozen=True)
class Workload:
    """A federated training task: model + loss + data schema + cost model."""

    name: str
    init_fn: Callable                    # (generator, device) -> flat params
    loss_fn: Callable                    # (views, xb, yb) -> (C,) losses
    eval_fn: Callable                    # (params, x, y, n_valid) -> 0-d
    make_data: Callable                  # (n_clients, seed=...) -> dataset
    sample_shape: tuple[int, ...]        # batch schema: per-sample x shape
    sample_dtype: str = "float32"        #   ... and dtype
    layout: ParamLayout = FEMNIST_MLP    # flat parameter layout
    # "host" runs the client stack on one device; "mesh" (clients as
    # devices) waits for the multi-device slice (ROADMAP).
    execution: str = "host"
    # --- cost model -----------------------------------------------------
    flops_per_sample: float | None = None
    train_flops_per_param: float | None = None
    inactive_params: int = 0
    samples_per_epoch: int = 275         # nominal local-epoch size
    bytes_per_param: int = C.BYTES_PER_PARAM
    # Calibration overrides (paper constants) win over derived numbers.
    model_bytes_override: int | None = None
    epoch_mflops_override: float | None = None
    # Platform overrides (radio / compute) for `HardwareModel.for_workload`.
    link_mbps: float | None = None
    gflops: float | None = None

    # ------------------------------------------------------------------ #
    def with_execution(self, execution: str) -> "Workload":
        """This workload, dispatched to `execution` ("host" | "mesh")."""
        return dataclasses.replace(
            self, execution=validate_execution(execution))

    @property
    def n_params(self) -> int:
        """Parameter count, from the flat layout."""
        return self.layout.size

    @property
    def active_params(self) -> int:
        """Parameters a training sample actually multiplies."""
        active = self.n_params - self.inactive_params
        if not 0 < active <= self.n_params:
            raise ValueError(
                f"workload {self.name!r}: inactive_params="
                f"{self.inactive_params} leaves no activated parameters "
                f"(n_params={self.n_params})")
        return active

    @property
    def model_bytes(self) -> int:
        """Bytes on the wire for one model transfer."""
        if self.model_bytes_override is not None:
            return int(self.model_bytes_override)
        return self.n_params * self.bytes_per_param

    @property
    def epoch_mflops(self) -> float:
        """MFLOPs for one local epoch on one client."""
        if self.epoch_mflops_override is not None:
            return float(self.epoch_mflops_override)
        fps = self.flops_per_sample
        if fps is None:
            if self.train_flops_per_param is None:
                raise ValueError(
                    f"workload {self.name!r} has no cost model: set "
                    "flops_per_sample, train_flops_per_param, or overrides")
            fps = self.train_flops_per_param * self.active_params
        return fps * self.samples_per_epoch / 1e6


def classification_workload(name: str, init_fn, apply_fn,
                            layout: ParamLayout = FEMNIST_MLP,
                            **cost) -> Workload:
    """Wrap an image-classifier (init, apply) pair: cross-entropy data
    loss, weighted-accuracy eval, FEMNIST shards."""
    return Workload(
        name=name,
        init_fn=init_fn,
        loss_fn=classification_loss(apply_fn),
        eval_fn=functools.partial(evaluate, apply_fn, layout=layout),
        make_data=synth_femnist,
        sample_shape=(IMG, IMG, 1),
        sample_dtype="float32",
        layout=layout,
        **cost,
    )


def _femnist_mlp() -> Workload:
    from repro_torch.models.femnist_mlp import (
        femnist_mlp_apply,
        femnist_mlp_init,
    )
    # Cost pinned to the paper's section-5 constants (186 KB / 98 MFLOP),
    # as in the reference, so the default path's timing is the seed's.
    return classification_workload(
        "femnist_mlp", femnist_mlp_init, femnist_mlp_apply,
        train_flops_per_param=6.0,
        model_bytes_override=C.MODEL_BYTES,
        epoch_mflops_override=C.EPOCH_MFLOPS,
    )


def _femnist_cnn() -> Workload:
    from repro_torch.models.femnist_cnn import (
        femnist_cnn_apply,
        femnist_cnn_init,
    )
    # Derived cost: conv FLOPs scale with spatial positions, not params.
    # fwd MACs = 28^2*(3*3*1*8) + 14^2*(3*3*8*16) + 784*56 + 56*47
    conv_macs = 28 * 28 * 3 * 3 * 1 * 8 + 14 * 14 * 3 * 3 * 8 * 16
    dense_macs = 7 * 7 * 16 * 56 + 56 * 47
    fwd_flops = 2.0 * (conv_macs + dense_macs)
    return classification_workload(
        "femnist_cnn", femnist_cnn_init, femnist_cnn_apply,
        layout=FEMNIST_CNN,
        flops_per_sample=3.0 * fwd_flops,    # fwd + ~2x fwd for backward
    )


_BUILDERS: dict[str, Callable[[], Workload]] = {
    "femnist_mlp": _femnist_mlp,
    "femnist_cnn": _femnist_cnn,
}
_CACHE: dict[str, Workload] = {}


def workload_names() -> list[str]:
    return sorted(_BUILDERS)


def get_workload(workload: str | Workload) -> Workload:
    """Resolve a registry name (or pass a Workload through unchanged)."""
    if isinstance(workload, Workload):
        return workload
    if workload in _NOT_PORTED:
        raise NotImplementedError(
            f"workload {workload!r}: {_NOT_PORTED[workload]}")
    if workload not in _BUILDERS:
        raise KeyError(
            f"unknown workload {workload!r}; registered: {workload_names()}")
    if workload not in _CACHE:
        _CACHE[workload] = _BUILDERS[workload]()
    return _CACHE[workload]
