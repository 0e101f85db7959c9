"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-architecture GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="yi-9b-smoke", num_layers=2, d_model=256,
                          num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512)
