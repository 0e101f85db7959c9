"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="stablelm-3b-smoke", num_layers=2, d_model=256,
                          num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512)
