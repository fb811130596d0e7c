"""Assigned input-shape cells, the same table as the reference's.

Every architecture is paired with four shapes:

    train_4k     seq 4,096   global_batch 256   (training step)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill)
    decode_32k   seq 32,768  global_batch 128   (one decode token, KV at 32k)
    long_500k    seq 524,288 global_batch 1     (long-context decode)

``long_500k`` requires sub-quadratic attention and is skipped (with reason)
for pure full-attention archs.  The reference's ``input_specs`` (abstract
``jax.ShapeDtypeStruct`` inputs for the dry-run) has no counterpart yet: it
comes with the meta-device estimator (ROADMAP Queue 1, item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.transformer import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

SHAPE_NAMES = tuple(SHAPES)


def cell_supported(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(supported, reason-if-not). The long-context rule from the brief."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: O(S^2) prefill / O(S) "
                       "per-token full KV at 512k — skipped per brief; run "
                       "for SSM/hybrid/SWA archs only")
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeCell, batch_override=None):
    raise NotImplementedError(
        "configs.shapes.input_specs is not ported yet: it comes with the "
        "meta-device dry-run estimator (ROADMAP Queue 1, item 16)")
