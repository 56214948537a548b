"""Assigned input shapes and per-(arch x shape) applicability rules.

LM transformer shapes are ``seq_len x global_batch``.  ``decode_*`` /
``long_*`` lower ``serve_step`` (one new token against a KV cache of
``seq_len``), not ``train_step``.  ``long_500k`` requires sub-quadratic
attention: it runs only for SSM/hybrid archs (rwkv6-1.6b, jamba-v0.1-52b)
and is skipped for pure full-attention archs (recorded in DESIGN.md).

A verbatim copy of ``repro/configs/shapes.py``, which holds no JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .base import ModelConfig, get_config, list_configs


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic attention (DESIGN.md §4)")
    return True, ""


def all_cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    """Every (arch, shape) pair that must be dry-run."""
    cells = []
    for arch in list_configs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = applicable(cfg, shape)
            if ok or include_skipped:
                cells.append((arch, shape.name))
    return cells
