"""The four assigned input shapes, with the reference's names and fields
(``repro/configs/shapes.py``): a training batch of 256 x 4,096 tokens, a
32 x 32,768-token prefill, a 128-sequence decode over 32,768 positions and
one 524,288-token decode."""
from repro_torch.configs.base import InputShape

TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256,
                      kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32,
                         kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128,
                        kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1,
                       kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
