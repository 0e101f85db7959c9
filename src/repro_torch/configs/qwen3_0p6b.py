"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm, head_dim=128, as the reference's
``repro/configs/qwen3_0p6b.py`` defines it (the published Qwen3-0.6B:
RoPE theta 1e6, tied embeddings, RMSNorm eps 1e-6, bf16)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen3-0.6b-smoke", num_layers=2, d_model=256,
                          num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                          vocab_size=512)
