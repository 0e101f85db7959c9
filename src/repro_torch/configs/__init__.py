"""DiT config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``."""
from __future__ import annotations

from repro_torch.configs import dit as _dit
from repro_torch.configs.base import DiTConfig, FastCacheConfig, ModelConfig

DIT_IDS = ("dit-s2", "dit-b2", "dit-l2", "dit-xl2")


def get_config(arch: str) -> ModelConfig:
    if arch not in DIT_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {DIT_IDS}")
    return getattr(_dit, arch.replace("-", "_").upper())


def get_reduced(arch: str) -> ModelConfig:
    if arch not in DIT_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {DIT_IDS}")
    return _dit.reduced()


__all__ = ["DiTConfig", "FastCacheConfig", "ModelConfig", "DIT_IDS",
           "get_config", "get_reduced"]
