"""The paper's own backbones: DiT-S/2, DiT-B/2, DiT-L/2, DiT-XL/2
(Peebles & Xie 2023; FastCache paper Table 4), as the reference defines them.

| Model    | Layers | Hidden | Heads |
| DiT-S/2  |   6    |  384   |   6   |
| DiT-B/2  |  12    |  768   |  12   |
| DiT-L/2  |  24    | 1024   |  16   |
| DiT-XL/2 |  28    | 1152   |  18   |

The reference's ``dit-xl2`` has 18 heads of 64 and ``learn_sigma=False``;
the published DiT-XL/2 has 16 heads of 72 and ``learn_sigma=True``.  The
port matches the reference.
"""
from repro_torch.configs.base import DiTConfig, ModelConfig


def _dit(name: str, layers: int, d: int, heads: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dit",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=4 * d,
        vocab_size=0,
        rope_kind="none",
        is_encoder=True,
        dit=DiTConfig(patch_size=2, in_channels=4, num_classes=1000,
                      image_size=32),
    )


DIT_S2 = _dit("dit-s2", 6, 384, 6)
DIT_B2 = _dit("dit-b2", 12, 768, 12)
DIT_L2 = _dit("dit-l2", 24, 1024, 16)
DIT_XL2 = _dit("dit-xl2", 28, 1152, 18)

CONFIG = DIT_XL2


def reduced(name: str = "dit-smoke") -> ModelConfig:
    return _dit(name, 2, 128, 4).replace(
        dit=DiTConfig(patch_size=2, in_channels=4, num_classes=10, image_size=8))
