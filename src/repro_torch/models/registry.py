"""Model construction from config (the reference's
``models/registry.py:build_model``): the DiT, and ``TransformerModel`` for
every other family (dense, MoE, SSM, hybrid, VLM and audio)."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.dit import DiTModel
from repro_torch.models.transformer import TransformerModel


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda"
                ) -> Union[DiTModel, TransformerModel]:
    if cfg.family == "dit":
        return DiTModel(cfg, device=device)
    return TransformerModel(cfg, device=device)
