"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE, as the reference's ``repro/configs/qwen2_vl_2b.py``
defines it (the published Qwen2-VL-2B language backbone, arXiv:2409.12191:
RoPE theta 1e6 over three sections (t, h, w) of 16, 24, 24 rotary
half-dims, tied embeddings, bf16).

The ViT vision encoder and projector are a stub, as in the reference: a
batch carries ``vision_embeds`` (B, vision_tokens, d_model) already in the
LM's embedding space, scattered into the token stream where
``vision_mask`` is set."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    vision_tokens=256,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen2-vl-2b-smoke", num_layers=2, d_model=256,
                          num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
                          mrope_sections=(8, 12, 12), vision_tokens=16)
