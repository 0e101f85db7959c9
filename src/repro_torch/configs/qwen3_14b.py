"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, head_dim=128 [hf:Qwen/Qwen3-8B family card]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen3-14b-smoke", num_layers=2, d_model=256,
                          num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                          vocab_size=512)
