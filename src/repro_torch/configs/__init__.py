"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``, for
the DiT ids and the ported LLM ids (the reference's ``configs/__init__.py``)."""
from __future__ import annotations

from repro_torch.configs import dit as _dit
from repro_torch.configs import qwen3_0p6b as _qwen3_0p6b
from repro_torch.configs.base import DiTConfig, FastCacheConfig, ModelConfig

DIT_IDS = ("dit-s2", "dit-b2", "dit-l2", "dit-xl2")
LLM_IDS = ("qwen3-0.6b",)
_LLM_MODULES = {"qwen3-0.6b": _qwen3_0p6b}


def get_config(arch: str) -> ModelConfig:
    if arch in DIT_IDS:
        return getattr(_dit, arch.replace("-", "_").upper())
    if arch in _LLM_MODULES:
        return _LLM_MODULES[arch].CONFIG
    raise KeyError(f"unknown arch {arch!r}; known: {DIT_IDS + LLM_IDS}")


def get_reduced(arch: str) -> ModelConfig:
    if arch in DIT_IDS:
        return _dit.reduced()
    if arch in _LLM_MODULES:
        return _LLM_MODULES[arch].reduced()
    raise KeyError(f"unknown arch {arch!r}; known: {DIT_IDS + LLM_IDS}")


__all__ = ["DiTConfig", "FastCacheConfig", "ModelConfig", "DIT_IDS",
           "LLM_IDS", "get_config", "get_reduced"]
