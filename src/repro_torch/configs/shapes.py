"""Assigned input-shape set for the LM-family architectures (port of
repro/configs/shapes.py).

Every (arch x shape) cell is well-defined; applicability rules:
  * decode_* / long_* run the serve step (1 new token + KV cache of
    seq_len)
  * long_500k runs only for sub-quadratic archs (ssm / hybrid / SWA-moe)
  * encoder frames / image patches are stubbed embeddings
`train_input_specs` returns `meta` tensors: shapes and dtypes with no
storage, the stand-ins of the dry run (launch/dryrun.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# chip count the global batches above assume (the single-pod production
# mesh); smaller worlds scale proportionally via shape_for_chips
PRODUCTION_CHIPS = 256


def shape_for_chips(shape: ShapeSpec, chips: int) -> ShapeSpec:
    """Scale a shape's global batch to a sub-mesh run (elastic world
    sizes, DESIGN.md §13): the per-chip batch is the invariant, so a run
    on fewer devices keeps the same local shapes."""
    if chips >= PRODUCTION_CHIPS:
        return shape
    gb = max(1, shape.global_batch * chips // PRODUCTION_CHIPS)
    return ShapeSpec(shape.name, shape.seq_len, gb, shape.kind)


# archs for which long_500k is runnable (sub-quadratic decode state)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def long_ok(cfg: ModelConfig) -> bool:
    if cfg.family in LONG_OK_FAMILIES:
        return True
    return cfg.sliding_window > 0          # SWA bounds the live KV window


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """-> (applicable, reason-if-not)."""
    if shape.name == "long_500k" and not long_ok(cfg):
        return False, "full quadratic attention; long_500k skipped (DESIGN.md)"
    return True, ""


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """tokens / labels (B, S) int32 on `meta`."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
            "labels": torch.empty((B, S), dtype=torch.int32, device="meta")}
