"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) per-expert
d_ff=2048, vocab=163840, MoE 384 experts top-8 + 1 shared expert
(DeepSeek-V3-style routing) [arXiv:2501.kimi2 paper table].

~1.04T total params, ~32B active. Optimizer: adafactor (factored second
moment) — AdamW f32 moments (8 TB) cannot fit 256x16GB HBM.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163_840,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1),
    optimizer="adafactor",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-k2-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      num_shared_experts=1),
    )
