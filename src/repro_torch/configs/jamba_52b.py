"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 interleave, MoE 16 experts top-2 on every other
FFN [arXiv:2403.19887].

Layer period of 8: [mamba x3, attn, mamba x4]; an FFN follows every mixer,
MoE on odd layer indices (moe_layer_period=2).  Jamba uses no positional
embedding.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    rope_kind="none",               # Jamba uses no positional embedding
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14_336,
                  moe_layer_period=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    optimizer="adafactor",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-52b-smoke", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=512, vocab_size=512,
        block_pattern=("mamba", "attn", "mamba", "mamba"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=512,
                      moe_layer_period=2),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    )
