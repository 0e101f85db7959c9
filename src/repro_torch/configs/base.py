"""Config dataclasses for the DiT serving path.

The port keeps its own copy of the JAX package's config types (it imports
nothing of ``repro``).  Only the fields the ported DiT path reads are kept;
their names, defaults and meanings are the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DiTConfig:
    patch_size: int = 2
    in_channels: int = 4             # SD VAE latent channels
    num_classes: int = 1000
    learn_sigma: bool = False
    image_size: int = 32             # latent spatial size (256px/8)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # "dit" is the only family ported so far
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    dit: Optional[DiTConfig] = None
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FastCacheConfig:
    """Paper defaults (§5.2 / Appendix E.1), as in the reference."""
    # STR — spatial token reduction
    motion_threshold: float = 0.05   # tau_s / tau_m
    motion_capacity: float = 0.5     # static top-C fraction
    # SC — statistical caching
    alpha: float = 0.05              # significance level of the chi^2 gate
    # MB — motion-aware blending
    blend_gamma: float = 0.5
    background_momentum: float = 0.7
    # module toggles for ablations
    use_str: bool = True
    use_sc: bool = True
    use_mb: bool = True
    # only "per_sample" is ported; "global" raises
    gate_mode: str = "per_sample"
