"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``, for
the DiT ids, the LLM ids (dense, MoE, hybrid, SSM and the VLM: the
decoders ``launch/serve.py`` serves) and the encoder ids (audio: encode
and train only), after the reference's ``configs/__init__.py``; ``--arch``
ids use the reference's spelling."""
from __future__ import annotations

from repro_torch.configs import arctic_480b as _arctic_480b
from repro_torch.configs import dit as _dit
from repro_torch.configs import hubert_xlarge as _hubert_xlarge
from repro_torch.configs import jamba_52b as _jamba_52b
from repro_torch.configs import kimi_k2_1t as _kimi_k2_1t
from repro_torch.configs import qwen2_vl_2b as _qwen2_vl_2b
from repro_torch.configs import qwen3_0p6b as _qwen3_0p6b
from repro_torch.configs import qwen3_14b as _qwen3_14b
from repro_torch.configs import stablelm_3b as _stablelm_3b
from repro_torch.configs import xlstm_1p3b as _xlstm_1p3b
from repro_torch.configs import yi_9b as _yi_9b
from repro_torch.configs.base import (DiTConfig, FastCacheConfig,
                                      InputShape, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.shapes import SHAPES

DIT_IDS = ("dit-s2", "dit-b2", "dit-l2", "dit-xl2")
_LLM_MODULES = {"qwen3-0.6b": _qwen3_0p6b, "stablelm-3b": _stablelm_3b,
                "arctic-480b": _arctic_480b, "kimi-k2-1t-a32b": _kimi_k2_1t,
                "qwen3-14b": _qwen3_14b, "yi-9b": _yi_9b,
                "jamba-v0.1-52b": _jamba_52b, "xlstm-1.3b": _xlstm_1p3b,
                "qwen2-vl-2b": _qwen2_vl_2b}
LLM_IDS = tuple(_LLM_MODULES)
_ENCODER_MODULES = {"hubert-xlarge": _hubert_xlarge}
ENCODER_IDS = tuple(_ENCODER_MODULES)
_MODULES = {**_LLM_MODULES, **_ENCODER_MODULES}
_KNOWN = DIT_IDS + tuple(_MODULES)
# the reference's assigned architectures (its ``--all`` sweeps), its order
ASSIGNED_ARCHS = ("hubert-xlarge", "qwen3-0.6b", "stablelm-3b",
                  "arctic-480b", "xlstm-1.3b", "kimi-k2-1t-a32b",
                  "qwen3-14b", "qwen2-vl-2b", "jamba-v0.1-52b", "yi-9b")


def get_config(arch: str) -> ModelConfig:
    if arch in DIT_IDS:
        return getattr(_dit, arch.replace("-", "_").upper())
    if arch in _MODULES:
        return _MODULES[arch].CONFIG
    raise KeyError(f"unknown arch {arch!r}; known: {_KNOWN}")


def get_reduced(arch: str) -> ModelConfig:
    if arch in DIT_IDS:
        return _dit.reduced()
    if arch in _MODULES:
        return _MODULES[arch].reduced()
    raise KeyError(f"unknown arch {arch!r}; known: {_KNOWN}")


__all__ = ["DiTConfig", "FastCacheConfig", "InputShape", "ModelConfig",
           "MoEConfig", "SSMConfig", "SHAPES",
           "ASSIGNED_ARCHS", "DIT_IDS", "ENCODER_IDS", "LLM_IDS",
           "get_config", "get_reduced"]
