"""Assigned-architecture registry: --arch <id> resolves here.

A copy of `repro.configs` (the configs are pure data); `femnist-47k`, the
paper's CNN client model, names the port's `femnist_cnn` functions.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "llava-next-mistral-7b",
    "qwen1.5-4b",
    "gemma-2b",
    "whisper-medium",
    "yi-9b",
    "deepseek-v3-671b",
    "grok-1-314b",
    "rwkv6-1.6b",
    "hymba-1.5b",
    "qwen1.5-110b",
    "femnist-47k",          # the paper's own client model
)

_MODULES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma-2b": "gemma_2b",
    "whisper-medium": "whisper_medium",
    "yi-9b": "yi_9b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "grok-1-314b": "grok_1_314b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen1.5-110b": "qwen1_5_110b",
    "femnist-47k": "femnist_47k",
}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; choices: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def lm_arch_ids() -> tuple[str, ...]:
    return tuple(a for a in ARCH_IDS if a != "femnist-47k")
