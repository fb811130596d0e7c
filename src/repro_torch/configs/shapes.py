"""Assigned input-shape cells, the same table as the reference's.

Every architecture is paired with four shapes:

    train_4k     seq 4,096   global_batch 256   (training step)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill)
    decode_32k   seq 32,768  global_batch 128   (one decode token, KV at 32k)
    long_500k    seq 524,288 global_batch 1     (long-context decode)

``decode_*``/``long_*`` run ``decode_step`` (one token against a cache of
``seq`` tokens), not a training step.  ``long_500k`` requires sub-quadratic
attention and is skipped (with reason) for pure full-attention archs.

``input_specs`` returns tensors on the ``meta`` device, the port's
counterpart of the reference's ``jax.ShapeDtypeStruct`` stand-ins: shapes
and dtypes, never storage, so the dry-run allocates nothing.  Modality
frontends are stubs: the VLM entry takes precomputed patch embeddings, the
audio entry precomputed frames.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import ArchConfig, init_cache


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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeCell,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this cell: a
    batch's tokens (and labels, patches, frames), or for decode one token a
    sequence and the zero cache of ``seq`` positions."""
    b = batch_override or shape.global_batch
    s = shape.seq
    if shape.kind in ("train", "prefill"):
        text = s - cfg.vision_prefix if cfg.vision_prefix else s
        spec: Dict[str, Any] = {"tokens": _meta((b, text), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = _meta((b, text), torch.int32)
        if cfg.vision_prefix:
            spec["patches"] = _meta((b, cfg.vision_prefix, cfg.d_model),
                                    cfg.dtype)
        if cfg.enc_dec:
            spec["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
        return spec
    # decode: one new token against a cache of `s` tokens
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": init_cache(cfg, b, s, device="meta")}
