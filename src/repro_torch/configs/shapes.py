"""The four assigned input-shape cells for every LM-family architecture."""

from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int         # context length (= KV length for decode kinds)
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}
