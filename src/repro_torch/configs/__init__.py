"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``, for
the DiT ids and the ported LLM ids, dense, MoE, hybrid and SSM (the
reference's ``configs/__init__.py``; ``--arch`` ids use the reference's
spelling)."""
from __future__ import annotations

from repro_torch.configs import arctic_480b as _arctic_480b
from repro_torch.configs import dit as _dit
from repro_torch.configs import jamba_52b as _jamba_52b
from repro_torch.configs import kimi_k2_1t as _kimi_k2_1t
from repro_torch.configs import qwen3_0p6b as _qwen3_0p6b
from repro_torch.configs import qwen3_14b as _qwen3_14b
from repro_torch.configs import stablelm_3b as _stablelm_3b
from repro_torch.configs import xlstm_1p3b as _xlstm_1p3b
from repro_torch.configs import yi_9b as _yi_9b
from repro_torch.configs.base import (DiTConfig, FastCacheConfig, ModelConfig,
                                      MoEConfig, SSMConfig)

DIT_IDS = ("dit-s2", "dit-b2", "dit-l2", "dit-xl2")
_LLM_MODULES = {"qwen3-0.6b": _qwen3_0p6b, "stablelm-3b": _stablelm_3b,
                "arctic-480b": _arctic_480b, "kimi-k2-1t-a32b": _kimi_k2_1t,
                "qwen3-14b": _qwen3_14b, "yi-9b": _yi_9b,
                "jamba-v0.1-52b": _jamba_52b, "xlstm-1.3b": _xlstm_1p3b}
LLM_IDS = tuple(_LLM_MODULES)


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


__all__ = ["DiTConfig", "FastCacheConfig", "ModelConfig", "MoEConfig",
           "SSMConfig",
           "DIT_IDS", "LLM_IDS", "get_config", "get_reduced"]
