"""hubert-xlarge [audio] — the encoder-only transformer of HuBERT X-Large
(arXiv:2106.07447), as the reference's ``repro/configs/hubert_xlarge.py``
defines it: 48L, d_model=1280, 16 heads (MHA), d_ff=5120 (LayerNorm, tanh
GELU FFN), vocab=504 (the k-means target codebook), bidirectional, no
RoPE (a 15-tap depthwise positional conv on the input), LayerNorm eps
1e-5.

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: a batch carries precomputed frame features (B, S,
frontend_dim=512)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    rope_kind="none",
    is_encoder=True,
    frontend_dim=512,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="hubert-xlarge-smoke", num_layers=2, d_model=256,
                          num_heads=4, num_kv_heads=4, d_ff=512, frontend_dim=64)
