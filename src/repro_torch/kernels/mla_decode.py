"""MLA decode attention on the latent cache: the Hopper kernel, its KV
split and its plain version.

``mla_attention(q, ckv, kpe, lens, scale, kv_len)`` takes the absorbed
queries q (B, H, R + P) (q_nope W_UK beside the roped q_pe), the latent
cache ckv (B, C, R) and kpe (B, C, P), and each sequence's length
``lens`` (B,) int32, and returns softmax(q [ckv | kpe]^T * scale) ckv
over each sequence's first ``lens[b]`` positions, (B, H, R) in q's dtype.

CUDA tensors go through ``csrc/mla_decode.cu`` or raise: bf16, of
DeepSeek-V3's widths (R 512, P 64) at H 16 (Moonlight's heads) or 32
(Kimi Linear's: a block a group of 16 heads), contiguous and on 16-byte
boundaries (:func:`kernel_refusal` names what a call lacks).  The kernel
reads each position's 576 cache values once (scores and the weighted sum
from one tile in shared memory) and counts the launch on
``mla_attention.launches``; a KV split (:func:`kv_split`, sized by
``kv_len``) spreads each sequence over the same number of blocks, which
share that sequence's own length evenly (the kernel reads it from
``lens``), and a second kernel merges them.  So ``kv_len`` sets only the
split: at the cache's capacity, as a captured decode step calls it, a
sequence's blocks are as long as at its own length.  CPU
tensors, and ``use_kernel=False``, run :func:`mla_attention_plain`: the
same sums in PyTorch, scores in fp32, P rounded to q's dtype for P ckv
as the kernel feeds it to the MMA, the sum of P in fp32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEADS, LATENT, ROPE = (16, 32), 512, 64   # the widths the kernel takes
BK = 32                              # cache positions a tile
BLOCKS_PER_SM = 2                    # 93,440 bytes of shared memory each
WAVES = 2                            # of blocks the split aims to fill


def kv_split(batch: int, kv_len: int) -> Tuple[int, int]:
    """(kv_chunk, splits): tiles of :data:`BK` a block of a ``kv_len``-
    position sequence and blocks a sequence, so that ``batch * splits``
    blocks fill :data:`WAVES` waves of the card's block slots where the
    cache is long enough.  The kernel takes ``splits``; a shorter
    sequence's blocks take shorter runs."""
    tiles = -(-kv_len // BK)
    want = -(-WAVES * BLOCKS_PER_SM * _build.SM_COUNT // batch)
    splits = max(1, min(tiles, want))
    chunk = -(-tiles // splits)
    return chunk, -(-tiles // chunk)


def mla_attention_plain(q: torch.Tensor, ckv: torch.Tensor,
                        kpe: torch.Tensor, lens: torch.Tensor, scale: float,
                        kv_len: int) -> torch.Tensor:
    r = ckv.shape[-1]
    c, p = ckv[:, :kv_len].float(), kpe[:, :kv_len].float()
    qf = q.float()
    s = (torch.bmm(qf[..., :r], c.transpose(1, 2))
         + torch.bmm(qf[..., r:], p.transpose(1, 2))) * scale
    past = (torch.arange(kv_len, device=q.device)[None, :]
            >= lens.view(-1, 1).to(q.device))
    s = s.masked_fill(past[:, None, :], float("-inf"))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    total = w.sum(dim=-1, keepdim=True)
    out = torch.bmm(w.to(q.dtype).float(), c) / total
    return out.to(q.dtype)


def kernel_refusal(q, ckv, kpe) -> str:
    """Why the kernel cannot take these operands, or "" where it can."""
    if not all(t.is_cuda for t in (q, ckv, kpe)):
        return "q, ckv and kpe must all be CUDA tensors"
    if not q.dtype == ckv.dtype == kpe.dtype == torch.bfloat16:
        return (f"the kernel takes bfloat16, got q {q.dtype}, ckv "
                f"{ckv.dtype}, kpe {kpe.dtype}")
    if q.shape[1] not in HEADS or q.shape[2] != LATENT + ROPE \
            or ckv.shape[-1] != LATENT or kpe.shape[-1] != ROPE:
        return (f"the kernel is built for {HEADS} heads, latent {LATENT} "
                f"and rope {ROPE}, got q {tuple(q.shape)}, ckv "
                f"{tuple(ckv.shape)}, kpe {tuple(kpe.shape)}")
    for name, t in (("q", q), ("ckv", ckv), ("kpe", kpe)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.data_ptr() % 16:
            return f"{name} must start on a 16-byte boundary"
    return ""


def mla_attention(q: torch.Tensor, ckv: torch.Tensor, kpe: torch.Tensor,
                  lens: torch.Tensor, scale: float, kv_len: int,
                  use_kernel: bool = True) -> torch.Tensor:
    """q (B, H, R + P), ckv (B, C, R), kpe (B, C, P), lens (B,) int32 in
    [1, kv_len], kv_len <= C -> (B, H, R)."""
    b = q.shape[0]
    if ckv.shape[:2] != kpe.shape[:2] or ckv.shape[0] != b or \
            q.shape[-1] != ckv.shape[-1] + kpe.shape[-1]:
        raise ValueError(f"bad MLA decode shapes q {tuple(q.shape)} ckv "
                         f"{tuple(ckv.shape)} kpe {tuple(kpe.shape)}")
    if not 1 <= kv_len <= ckv.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside the cache's "
                         f"{ckv.shape[1]} positions")
    if q.device.type == "cpu" or not use_kernel:
        return mla_attention_plain(q, ckv, kpe, lens, scale, kv_len)
    refusal = kernel_refusal(q, ckv, kpe)
    if refusal:
        raise ValueError(f"MLA decode kernel: {refusal} (use_kernel=False "
                         f"runs the plain version)")
    splits = kv_split(b, kv_len)[1]
    h = q.shape[1]
    out = torch.empty((b, h, LATENT), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, b, h, LATENT), device=q.device)
        part_ml = torch.empty((splits, b, h, 2), device=q.device)
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    # the raw current stream, as the RMSNorm wrapper takes it: a Stream
    # object costs microseconds a call, and a step makes one a layer
    args = (q.data_ptr(), ckv.data_ptr(), kpe.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, ckv.shape[1], float(scale), splits,
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            torch._C._cuda_getCurrentRawStream(q.device.index))
    if q.device.index == torch.cuda.current_device():
        rc = _lib().repro_mla_decode(*args)
    else:
        with torch.cuda.device(q.device):
            rc = _lib().repro_mla_decode(*args)
    if rc != 0:
        raise RuntimeError(f"MLA decode kernel launch failed (code {rc}) for "
                           f"q {tuple(q.shape)} cache {tuple(ckv.shape)} "
                           f"kv_len {kv_len}")
    mla_attention.launches += 1
    return out


mla_attention.launches = 0


def _bind(lib) -> None:
    lib.repro_mla_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.repro_mla_decode.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("mla_decode", _bind)
