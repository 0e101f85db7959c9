"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 WITH a parallel dense FFN residual branch
(Arctic's dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base].

Optimizer: adafactor — factored second moment so ~480B params of optimizer
state fit the 256/512-chip HBM budget (see DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_ff_parallel=4864),
    optimizer="adafactor",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="arctic-480b-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=512,
                      dense_ff_parallel=512),
    )
