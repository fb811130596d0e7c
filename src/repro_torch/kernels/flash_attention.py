"""Causal / sliding-window GQA flash attention: the Hopper kernel, its run
geometry and its plain version.

``flash_attention(q, k, v)`` takes q (B, S, HQ, D) and k, v (B, S, HKV, D)
with HQ % HKV == 0 and returns (B, S, HQ, D) in q's dtype: the reference
Pallas kernel's function (forward only; online softmax with an fp32 running
max, sum and accumulator; scores scaled after Q K^T; masked scores -1e30;
a fully masked row divides by 1).

For CUDA tensors it launches ``csrc/flash_attention.cu`` and counts the
launch on ``flash_attention.launches``: bf16 runs on the tensor cores
(``mma.sync``, P rounded to bf16 for P V), fp32 on the FFMA kernel, which
keeps IEEE fp32.  For CPU tensors, or with ``use_kernel=False``, it runs
:func:`flash_attention_plain`, which walks the same run tiles in PyTorch:
the same KV-tile bounds, the same online softmax, tile by tile, and for
bf16 the same rounding of P.  The requested ``block_q``/``block_k`` (the
reference's knobs) map onto the compiled templates by :func:`legalize`;
``flash_attention.last_geometry`` records both.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BQ_TEMPLATES = (16, 32, 64)
BK_TEMPLATES = (16, 32, 64)
DP_TEMPLATES = (16, 32, 64, 128)     # head_dim, padded up
SMEM_BUDGET = 100 * 1024             # two blocks an SM (227 KB each)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class RunGeometry:
    """The compiled template one launch runs."""
    bq: int
    bk: int
    dp: int
    dtype: str = "float32"

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory (see csrc/flash_attention.cu).  fp32 (the
        FFMA kernel): Q [bq][dp+1], K [bk][dp+1], V [bk][dp] and
        P [bq][bk+1], 4 bytes each.  bf16 (the tensor-core kernel): Q
        [bq][dp+8] and two stages of K and V [bk][dp+8], 2 bytes each."""
        if self.dtype == "bfloat16":
            return 2 * (self.bq + 4 * self.bk) * (self.dp + 8)
        return 4 * (self.bq * (self.dp + 1) + self.bk * (self.dp + 1)
                    + self.bk * self.dp + self.bq * (self.bk + 1))


def _pick(templates: Tuple[int, ...], requested: int, dim: int) -> int:
    target = min(int(requested), int(dim))
    fits = [t for t in templates if t <= target]
    return max(fits) if fits else templates[0]


def legalize(block_q: int, block_k: int, s: int, d: int,
             dtype: torch.dtype = torch.float32) -> RunGeometry:
    """Requested blocks -> run geometry.  As the reference clamps each
    block to the sequence (``min(block, s)``), each run tile is the largest
    template not above it (else the smallest, with the tail masked); dp is
    the smallest template that holds head_dim; then bk halves until the
    tiles fit the shared-memory budget (only fp32 tiles ever need it)."""
    if d > DP_TEMPLATES[-1]:
        raise ValueError(f"flash attention kernel takes head_dim <= "
                         f"{DP_TEMPLATES[-1]}, got {d}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    dp = next(t for t in DP_TEMPLATES if t >= d)
    geom = RunGeometry(_pick(BQ_TEMPLATES, block_q, s),
                       _pick(BK_TEMPLATES, block_k, s), dp,
                       str(dtype).removeprefix("torch."))
    while geom.smem_bytes > SMEM_BUDGET and geom.bk > BK_TEMPLATES[0]:
        geom = dataclasses.replace(geom, bk=geom.bk // 2)
    return geom


def kv_tile_range(q0: int, bq: int, bk: int, s: int, causal: bool,
                  window: Optional[int]) -> Tuple[int, int]:
    """First and last KV tile a query tile starting at ``q0`` can see: the
    reference's block skip (``pl.when(relevant)``) as loop bounds."""
    hi = -(-s // bk) - 1
    if causal:
        hi = min(hi, (q0 + bq - 1) // bk)
    lo = 0
    if window is not None:
        first = q0 - window + 2 - bk   # least k0 with k0+bk-1 >= q0-window+1
        if first > 0:
            lo = -(-first // bk)
    return lo, hi


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} differ "
                         f"in batch, sequence or head_dim")
    if min(b, s, hq, d, k.shape[2]) < 1 or hq % k.shape[2]:
        raise ValueError(f"need HQ % HKV == 0 and nonempty tensors, got "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention takes float32 or bfloat16 tensors of one "
                        f"dtype, got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device} {k.device} {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: Optional[int], scale: float,
                          geom: RunGeometry) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch over the same run geometry: per
    (bq) query tile, the KV tiles of :func:`kv_tile_range` in order, each
    folded into an fp32 running max, sum and accumulator; tails by slicing
    (the kernel's zero-filled tails give the same result).  For bf16
    inputs P is rounded to bf16 before P V, as the tensor-core kernel
    feeds it to the MMA, while the sum l takes the fp32 P."""
    round_p = q.dtype == torch.bfloat16
    b, s, hq, d = q.shape
    group = hq // k.shape[2]
    qf = q.float().transpose(1, 2)                                 # B,HQ,S,D
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    out = torch.empty((b, hq, s, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, geom.bq):
        qt = qf[:, :, q0:q0 + geom.bq]
        rows = torch.arange(q0, q0 + qt.shape[2], device=q.device)[:, None]
        m = torch.full(qt.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros(qt.shape[:3], device=q.device)
        acc = torch.zeros(qt.shape, device=q.device)
        lo, hi = kv_tile_range(q0, geom.bq, geom.bk, s, causal, window)
        for j in range(lo, hi + 1):
            k0 = j * geom.bk
            kt = kf[:, :, k0:k0 + geom.bk]
            vt = vf[:, :, k0:k0 + geom.bk]
            sc = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            cols = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None]
            mask = torch.ones_like(sc[0, 0], dtype=torch.bool)
            if causal:
                mask &= cols <= rows
            if window is not None:
                mask &= cols > rows - window
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            if round_p:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.matmul(p, vt)
            m = m_new
        denom = torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, q0:q0 + qt.shape[2]] = acc / denom[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128,
                    use_kernel: bool = True) -> torch.Tensor:
    """q: (B, S, HQ, D); k, v: (B, S, HKV, D) -> (B, S, HQ, D).

    CUDA tensors go through the Hopper kernel (or raise); CPU tensors, and
    ``use_kernel=False``, take the plain version of the same geometry."""
    _check(q, k, v, window)
    b, s, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    geom = legalize(block_q, block_k, s, d, q.dtype)
    flash_attention.last_geometry = {
        "requested": {"block_q": int(block_q), "block_k": int(block_k)},
        "run": dataclasses.asdict(geom)}
    if q.device.type == "cpu" or not use_kernel:
        return flash_attention_plain(q, k, v, causal, window, scale, geom)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel's output would carry no grad_fn: refuse, not cut
        raise RuntimeError(
            "the flash attention kernel is forward-only (the reference "
            "kernel has no backward); call it under torch.no_grad() or on "
            "tensors that do not require grad; training attention is "
            "models.layers.chunked_attention")
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernel takes contiguous "
                         "(B, S, H, D) operands")
    # 16-byte copies: whole 8-element chunks, rows on 16-byte boundaries
    vec = q.dtype == torch.bfloat16 and d % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, k.shape[2], d, float(scale), int(bool(causal)),
            0 if window is None else int(window), _DTYPE_CODE[q.dtype],
            geom.bq, geom.bk, geom.dp, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed (code {rc})"
                           f" for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype} geometry {geom}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.last_geometry = None


def _bind(lib) -> None:
    lib.repro_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _bind)
