"""Assigned input shapes (arch x shape grid for the dry-run / roofline).

A copy of the JAX package's ``configs/shapes.py``.

LM transformer shapes are (seq_len, global_batch).  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a seq_len KV cache / state), NOT
``train_step``; ``prefill_*`` lowers the prefill serve path; ``train_*``
lowers ``train_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

__all__ = ["ShapeSpec", "SHAPES", "shape_by_name"]

Kind = Literal["train", "prefill", "decode"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", 4_096, 256),
    ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    ShapeSpec("decode_32k", "decode", 32_768, 128),
    ShapeSpec("long_500k", "decode", 524_288, 1),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")
