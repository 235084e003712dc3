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

Ported: `femnist_mlp`, the paper's sweep model, whose cost numbers are
pinned to the paper's section-5 constants (so
`HardwareModel.for_workload("femnist_mlp") == HardwareModel()`);
`femnist_cnn`, the paper's headline 47k-parameter CNN, whose cost is
derived from its conv/dense dims; and the LM workloads `lm_tiny`,
`lm_hybrid_tiny`, `lm_rwkv6_tiny` and `lm_moe_tiny` (a reduced
deepseek-v3: MLA, routed experts and the MTP head) (`lm_workload`: any
ported LM config federated over token shards). An LM client stack is one
(C, P) float32 buffer laid out as the config's param tree
(`ParamLayout.of_tree`), trained by one forward and backward for the
whole stack (`client_lm_losses`). Every workload of the reference is
ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.client import classification_loss, evaluate
from repro_torch.data.femnist import IMG, synth_femnist
from repro_torch.data.tokens import federated_token_shards
from repro_torch.orbits import constants as C
from repro_torch.params import FEMNIST_CNN, FEMNIST_MLP, ParamLayout

EXECUTION_MODES = ("host", "mesh")

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
    # "host" runs the client stack on one device and aggregates it there;
    # "mesh" makes every participating client a pod slot of a process
    # group (`launch.fl_round.make_mesh_round_step`): each rank trains its
    # block of slots and one masked, weighted all-reduce aggregates.
    # `ConstellationSim(..., execution=...)` overrides per run.
    execution: str = "host"
    # Batch-key ranks for the launch-style dict-batch contract
    # (`make_fl_round_step`; leading dim split over the pods); None = the
    # engine's (x, y) schema.
    mesh_batch_dims: dict[str, int] | None = None
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


def make_lm_evaluate(cfg, layout: ParamLayout | None = None) -> Callable:
    """Weighted next-token accuracy over stacked eval clients.

    x: (K, N, S+1) integer token rows; y is ignored (targets are x
    shifted); n_valid: (K,) valid-row counts. Mirrors `client.evaluate`'s
    contract so the engine's padded-eval path works unchanged. `params`
    is the model's tree, or its flat (P,) buffer when `layout` is given.
    All K * N rows go through one forward (the reference vmaps over K)."""
    from repro_torch.models.lm.transformer import forward_train

    @torch.no_grad()
    def lm_evaluate(params, x, y, n_valid):
        del y
        if layout is not None:
            params = layout.views(params)
        K, N, S1 = x.shape
        rows = x.reshape(K * N, S1).long()
        logits, _ = forward_train(cfg, params, rows)
        pred = torch.argmax(logits[:, :-1, :], dim=-1)
        correct = (pred == rows[:, 1:]).float().mean(-1).view(K, N)
        mask = (torch.arange(N, device=x.device)[None, :]
                < n_valid[:, None]).float()
        return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return lm_evaluate


def lm_inactive_params(cfg) -> int:
    """Parameters of an LM ModelConfig that sit in the tree (and on the
    wire) but that a training token never multiplies (the reference's
    `lm_inactive_params`): an untied embedding table is a per-token row
    gather, and a "moe" layer fires only `top_k` of its `n_experts`
    routed experts per token. Dense "attn" / "rwkv" / "hybrid" layers
    touch every weight."""
    inactive = 0
    if not cfg.tie_embeddings:
        inactive += cfg.vocab_size * cfg.d_model
    if cfg.moe is not None:
        mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        per_expert = mats * cfg.d_model * cfg.moe.d_ff_expert
        idle = cfg.moe.n_experts - min(cfg.moe.top_k, cfg.moe.n_experts)
        moe_layers = sum(s.n_layers for s in cfg.resolved_segments
                         if s.kind == "moe")
        inactive += moe_layers * idle * per_expert
    return inactive


def lm_layout(cfg) -> ParamLayout:
    """The flat layout of an LM config's param tree (leaves in
    `jax.tree.leaves` order, the `"segments"` list by index)."""
    from repro_torch.models.lm.transformer import init_params
    return ParamLayout.of_tree(
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"))


def lm_workload(cfg, *, name: str | None = None, seq_len: int = 32,
                samples_per_client: int = 32, eval_samples: int = 8
                ) -> Workload:
    """Federate an LM ModelConfig (float32) over token shards.

    The cost model is the reference's: 6 FLOP per activated parameter per
    token (fwd+bwd), (seq_len + 1) tokens per sample row; the parameter
    count comes from the real parameter tree and prices the wire. The
    client stack trains as one (C, P) float32 buffer, so the config's
    dtype must be float32 (both LM workloads' is)."""
    from repro_torch.models.lm.transformer import init_params
    from repro_torch.train.step import client_lm_losses

    if cfg.encoder is not None:
        raise ValueError(f"lm_workload({cfg.name}): an enc-dec model needs "
                         "frame embeddings, which token shards do not carry")
    if cfg.dtype != "float32":
        raise ValueError(f"lm_workload({cfg.name}): the client stack is one "
                         f"float32 buffer; config dtype is {cfg.dtype}")
    layout = lm_layout(cfg)

    def init_fn(generator, device):
        return layout.pack(init_params(cfg, generator, device))

    def loss_fn(views, xb, yb):
        del yb                     # targets are xb shifted by one token
        return client_lm_losses(cfg, views, xb)

    return Workload(
        name=name or f"lm_{cfg.name}",
        init_fn=init_fn,
        loss_fn=loss_fn,
        eval_fn=make_lm_evaluate(cfg, layout),
        make_data=functools.partial(
            federated_token_shards, seq_len=seq_len,
            samples_per_client=samples_per_client, vocab=cfg.vocab_size,
            eval_samples=eval_samples),
        sample_shape=(seq_len + 1,),
        sample_dtype="int32",
        layout=layout,
        mesh_batch_dims={"tokens": 2},
        train_flops_per_param=6.0 * (seq_len + 1),
        inactive_params=lm_inactive_params(cfg),
        samples_per_epoch=samples_per_client,
        bytes_per_param=4,
    )


def _lm_tiny() -> Workload:
    from repro_torch.models.lm.config import ModelConfig
    cfg = ModelConfig(
        name="tiny", arch_type="dense", n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=32,
        tie_embeddings=True, dtype="float32",
        source="reduced dense decoder for constellation fine-tuning")
    return lm_workload(cfg, name="lm_tiny", seq_len=32,
                       samples_per_client=32, eval_samples=8)


def _lm_moe_tiny() -> Workload:
    """Reduced DeepSeek-V3: 3 dense MLA layers + 1 MoE layer (1 shared +
    8 routed experts, top-2) + MTP head. The crossover workload: every
    expert rides the wire (`model_bytes` counts all 8), but per-token
    FLOPs only touch 2: small epoch time against large model bytes."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b").reduced(n_layers=4, n_experts=8)
    return lm_workload(cfg, name="lm_moe_tiny", seq_len=32,
                       samples_per_client=32, eval_samples=8)


def _lm_rwkv6_tiny() -> Workload:
    """Reduced RWKV6 (Finch): 2 attention-free time-mix/channel-mix
    layers. Fully dense per token: only the untied embedding gather
    separates activated from total parameters."""
    from repro_torch.configs import get_config
    return lm_workload(get_config("rwkv6-1.6b").reduced(),
                       name="lm_rwkv6_tiny", seq_len=32,
                       samples_per_client=32, eval_samples=8)


def _lm_hybrid_tiny() -> Workload:
    """Reduced Hymba: 2 hybrid layers (parallel sliding-window attention
    + SSD heads; the first is a full-attention anchor)."""
    from repro_torch.configs import get_config
    return lm_workload(get_config("hymba-1.5b").reduced(),
                       name="lm_hybrid_tiny", seq_len=32,
                       samples_per_client=32, eval_samples=8)


# Registry entries are built lazily (an LM workload builds its layout
# from a param tree) and cached after first use.
_BUILDERS: dict[str, Callable[[], Workload]] = {
    "femnist_mlp": _femnist_mlp,
    "femnist_cnn": _femnist_cnn,
    "lm_tiny": _lm_tiny,
    "lm_moe_tiny": _lm_moe_tiny,
    "lm_rwkv6_tiny": _lm_rwkv6_tiny,
    "lm_hybrid_tiny": _lm_hybrid_tiny,
}
_CACHE: dict[str, Workload] = {}


def register_workload(name: str, builder: Callable[[], Workload]) -> None:
    """Add a workload to the registry (idempotent per name)."""
    _BUILDERS[name] = builder
    _CACHE.pop(name, None)


def workload_names() -> list[str]:
    return sorted(_BUILDERS)


def get_workload(workload: str | Workload) -> Workload:
    """Resolve a registry name (or pass a Workload through unchanged)."""
    if isinstance(workload, Workload):
        return workload
    if workload not in _BUILDERS:
        raise KeyError(
            f"unknown workload {workload!r}; registered: {workload_names()}")
    if workload not in _CACHE:
        _CACHE[workload] = _BUILDERS[workload]()
    return _CACHE[workload]
