"""xlstm-1.3b [ssm] — 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.
sLSTM + mLSTM blocks [arXiv:2405.04517].  One sLSTM block every 8 layers
(xLSTM[7:1]-style); the mLSTM uses a 2x up-projection with matrix memory,
so there is no separate FFN (d_ff=0).  Its q/k/v projections are dense
(inner x inner), as the reference's, so the full config holds 3.60 B
parameters."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    rope_kind="none",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm=SSMConfig(slstm_every=8, proj_factor=2.0, conv_kernel=4, chunk_size=64),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-1.3b-smoke", num_layers=2, d_model=256, num_heads=2,
        num_kv_heads=2, vocab_size=512, block_pattern=("mlstm", "slstm"),
        ssm=SSMConfig(slstm_every=2, chunk_size=16),
    )
