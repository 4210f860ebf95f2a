"""The assigned input-shape set (same four shapes for every LM arch).

``train_*`` lowers ``train_step``; ``prefill_*`` lowers the prefill graph;
``decode_*`` / ``long_*`` lower ``serve_step`` (ONE new token against a KV
cache of ``seq_len``), per the assignment brief.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = Shape("train_4k", 4_096, 256, "train")
PREFILL_32K = Shape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = Shape("decode_32k", 32_768, 128, "decode")
LONG_500K = Shape("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}
