"""Assigned input-shape cells (one set, paired with every LM-family arch)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# fixed encoder length for enc-dec decode cells (whisper: 30 s ≈ 1500 frames
# at the stub frontend's post-conv rate; capped for cache-only cells)
ENCDEC_DECODE_ENC_LEN = 1500
