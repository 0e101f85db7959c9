"""Config dataclasses for the DiT and the LLM paths (dense, MoE, SSM,
hybrid, VLM and audio).

The port keeps its own copy of the JAX package's config types
(``repro/configs/base.py``; it imports nothing of ``repro``).  Only the
fields the ported paths read are kept; their names, defaults and meanings
are the reference's, except that ``num_kv_heads`` and ``vocab_size`` default
to 0 here (the reference requires them), so a DiT config can be built
without them, as before the LLM slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0      # DeepSeek/Kimi-style always-on experts
    dense_ff_parallel: int = 0       # Arctic-style dense FFN residual branch
    capacity_factor: float = 1.25
    min_capacity: int = 4
    router_aux_weight: float = 0.01
    moe_layer_period: int = 1        # MoE every k-th FFN (Jamba: 2)


@dataclass(frozen=True)
class SSMConfig:
    # xLSTM
    slstm_every: int = 8             # every k-th block is sLSTM (rest mLSTM)
    proj_factor: float = 2.0         # mLSTM up-projection factor
    conv_kernel: int = 4
    chunk_size: int = 64             # chunkwise-parallel mLSTM chunk
    # Mamba (Jamba mixers)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model/16)


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
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | dit
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    num_kv_heads: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    rope_kind: str = "default"       # default | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # per-axis half-dims (t,h,w)
    is_encoder: bool = False         # bidirectional attention, no decode step
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention; >0 enables SWA variant
    norm_eps: float = 1e-6
    # Hybrid layout: pattern of one period, tiled over num_layers.
    # entries: "attn" | "mamba" | "mlstm" | "slstm" (all four ported)
    block_pattern: Tuple[str, ...] = ()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    dit: Optional[DiTConfig] = None
    # Audio/VLM frontends are stubbed: inputs are precomputed embeddings.
    frontend_dim: int = 0            # e.g. hubert conv-feature dim (512)
    vision_tokens: int = 0           # VLM: number of image-patch embeddings
    dtype: str = "bfloat16"
    # Training
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind, length == num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        p = self.block_pattern
        reps = -(-self.num_layers // len(p))
        return (p * reps)[: self.num_layers]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    """One of the assigned input shapes (``configs/shapes.py``), as the
    reference's."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


@dataclass(frozen=True)
class FastCacheConfig:
    """Paper defaults (§5.2 / Appendix E.1), as in the reference."""
    enabled: bool = True
    # STR — spatial token reduction
    motion_threshold: float = 0.05   # tau_s / tau_m
    motion_capacity: float = 0.5     # static top-C fraction
    # SC — statistical caching
    alpha: float = 0.05              # significance level of the chi^2 gate
    # MB — motion-aware blending
    blend_gamma: float = 0.5
    background_momentum: float = 0.7
    # CTM — token merging
    merge_enabled: bool = False
    merge_window: int = 16
    merge_ratio: float = 0.5         # kept-token fraction per window
    knn_k: int = 5
    merge_lambda: float = 1.0        # lambda in Eq. 12
    # module toggles for ablations
    use_str: bool = True
    use_sc: bool = True
    use_mb: bool = True
    # gating granularity: "per_sample" gates each batch element
    # independently; "global" reduces the statistic over the batch (one
    # decision per layer, an ablation)
    gate_mode: str = "per_sample"
