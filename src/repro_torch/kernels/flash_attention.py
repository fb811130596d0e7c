"""Causal / sliding-window GQA flash attention: the Hopper kernel, its run
geometry and its plain version.

``flash_attention(q, k, v)`` takes q (B, S, HQ, D) and k, v (B, S, HKV, D)
with HQ % HKV == 0 and returns (B, S, HQ, D) in q's dtype: the reference
Pallas kernel's function (forward only; online softmax with an fp32 running
max, sum and accumulator; scores scaled after Q K^T; masked scores -1e30;
a fully masked row divides by 1).

For CUDA tensors it launches ``csrc/flash_attention.cu`` and counts the
launch on ``flash_attention.launches`` and, by (q's shape, HKV, causal,
window, block_q, block_k, dtype), on ``flash_attention.calls``: bf16 runs
on the tensor cores (``mma.sync``, P rounded to bf16 for P V), fp32 on the
FFMA pipes (``flash_f32_kernel``: register microtiles fed from shared
memory by a ``cp.async`` ring), which keeps IEEE fp32.  For CPU tensors,
or with ``use_kernel=False``, it runs :func:`flash_attention_plain`, which
walks the same run tiles in PyTorch: the same KV-tile bounds, the same
online softmax, tile by tile, and for bf16 the same rounding of P.  The
requested ``block_q``/``block_k`` (the reference's knobs) map onto the
compiled templates by :func:`legalize`; ``flash_attention.last_geometry``
records both.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BQ_TEMPLATES = (16, 32, 64)
BK_TEMPLATES = (16, 32, 64)
# head_dim, padded up (bf16); 192 for MLA's (nope 128 + rope 64) keys
DP_TEMPLATES = (16, 32, 64, 128, 192)
F32_DP_TEMPLATES = (32, 64, 128)     # fp32: 8 threads x a float4 a row
SMEM_BUDGET = 100 * 1024             # bf16: two blocks an SM (227 KB each)
# fp32: the H100's shared memory an SM (228 KB, of which a block takes at
# most 227 KB and 1 KB more for itself) must hold at least 8 warps
SM_SMEM_BYTES = 228 * 1024
BLOCK_SMEM_RESERVED = 1024
F32_MIN_WARPS = 8
# fp32 KV split (kv_split): a run's KV tiles, at least; split where the
# longest query tile holds SPLIT_RATIO times a block slot's mean share of
# the KV tiles or more; runs of a slot's share / SLOT_RUNS (measured on
# the fp32 gates' shapes: PERF.md's kernel table)
MIN_KV_CHUNK = 2
SPLIT_RATIO = 2
SLOT_RUNS = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class RunGeometry:
    """The compiled template one launch runs and, for fp32, its KV split:
    ``kv_chunk`` > 0 cuts each query tile's KV range into runs of that
    many tiles, one block each, merged by a second kernel (0: no split;
    :func:`kv_split` decides)."""
    bq: int
    bk: int
    dp: int
    dtype: str = "float32"
    kv_chunk: int = 0

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory (see csrc/flash_attention.cu).  fp32
        (``f32_smem_bytes``): Q [bq][dp+4], two stages of K [bk][dp+4] and
        of V [bk][dp], and P^T [bk][bq+4], 4 bytes each.  bf16
        (``mma_smem_bytes``): Q [bq][dp+8] and two stages of K and V
        [bk][dp+8], 2 bytes each."""
        if self.dtype == "bfloat16":
            return 2 * (self.bq + 4 * self.bk) * (self.dp + 8)
        return 4 * (self.bq * (self.dp + 4) + 2 * self.bk * (self.dp + 4)
                    + 2 * self.bk * self.dp + self.bk * (self.bq + 4))

    @property
    def threads(self) -> int:
        """A block's threads: 2 bq in either kernel (bf16 a warp per 16
        query rows; fp32 8 threads per 4 rows)."""
        return 2 * self.bq

    @property
    def warps_per_sm(self) -> int:
        """Warps an SM holds by shared memory (registers never bind below
        8 warps: 255 a thread fits 256 threads)."""
        blocks = min(32, SM_SMEM_BYTES
                     // (self.smem_bytes + BLOCK_SMEM_RESERVED))
        return blocks * self.threads // 32


def _pick(templates: Tuple[int, ...], requested: int, dim: int) -> int:
    target = min(int(requested), int(dim))
    fits = [t for t in templates if t <= target]
    return max(fits) if fits else templates[0]


def legalize(block_q: int, block_k: int, s: int, d: int,
             dtype: torch.dtype = torch.float32) -> RunGeometry:
    """Requested blocks -> run geometry, the one place that decides which
    template runs.  As the reference clamps each block to the sequence
    (``min(block, s)``), each run tile is the largest template not above
    it (else the smallest, with the tail masked); dp is the smallest
    template of the dtype that holds head_dim.  bf16 keeps these where its
    tiles fit :data:`SMEM_BUDGET` (every dp up to 128); at dp 192 bk
    halves until they do.  fp32: bk halves until an SM
    holds :data:`F32_MIN_WARPS` warps of the template, and where bk 16
    still does not (dp 128 at bq 16), bq doubles."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    f32 = dtype == torch.float32
    top = (F32_DP_TEMPLATES if f32 else DP_TEMPLATES)[-1]
    if d > top:
        raise ValueError(f"flash attention kernel takes head_dim <= {top} "
                         f"in {dtype}, got {d}")
    dp = next(t for t in (F32_DP_TEMPLATES if f32 else DP_TEMPLATES)
              if t >= d)
    geom = RunGeometry(_pick(BQ_TEMPLATES, block_q, s),
                       _pick(BK_TEMPLATES, block_k, s), dp,
                       str(dtype).removeprefix("torch."))
    if not f32:
        while geom.smem_bytes > SMEM_BUDGET and geom.bk > BK_TEMPLATES[0]:
            geom = dataclasses.replace(geom, bk=geom.bk // 2)
        return geom
    while geom.warps_per_sm < F32_MIN_WARPS and geom.bk > BK_TEMPLATES[0]:
        geom = dataclasses.replace(geom, bk=geom.bk // 2)
    while geom.warps_per_sm < F32_MIN_WARPS and geom.bq < BQ_TEMPLATES[-1]:
        geom = dataclasses.replace(geom, bq=geom.bq * 2)
    return geom


@functools.lru_cache(maxsize=None)
def f32_templates() -> frozenset:
    """Every fp32 (bq, bk, dp) that :func:`legalize` can pick: the
    templates ``csrc/flash_attention.cu::dispatch_f32`` compiles."""
    return frozenset(
        (g.bq, g.bk, g.dp) for g in (
            legalize(bq, bk, max(bq, bk), dp)
            for bq in BQ_TEMPLATES for bk in BK_TEMPLATES
            for dp in F32_DP_TEMPLATES))


def kv_split(geom: RunGeometry, heads: int, s: int, causal: bool,
             window: Optional[int]) -> RunGeometry:
    """fp32: where the grid's ``heads`` (B * HQ) x query tiles fill less
    than one wave of the card's block slots and the longest query tile's
    KV loop is at least :data:`SPLIT_RATIO` times a slot's mean share of
    all the KV tiles, that loop would run alone on one SM at the end.
    Then each tile's KV range is cut into runs of ``kv_chunk`` tiles (a
    slot's share / :data:`SLOT_RUNS`, at least :data:`MIN_KV_CHUNK`,
    evened out over the longest tile's runs), one block each, and a
    second kernel merges them.  bf16 runs unsplit."""
    if geom.dtype != "float32":
        return geom
    n_q = -(-s // geom.bq)
    lengths = [hi - lo + 1 for lo, hi in (
        kv_tile_range(t * geom.bq, geom.bq, geom.bk, s, causal, window)
        for t in range(n_q))]
    slots = _build.SM_COUNT * (geom.warps_per_sm * 32 // geom.threads)
    work = heads * sum(lengths)
    if heads * n_q >= slots or max(lengths) * slots < SPLIT_RATIO * work:
        return geom
    chunk = max(MIN_KV_CHUNK, -(-work // (SLOT_RUNS * slots)))
    runs = -(-max(lengths) // chunk)
    if runs < 2:
        return geom
    return dataclasses.replace(geom, kv_chunk=-(-max(lengths) // runs))


def kv_runs(lo: int, hi: int, kv_chunk: int) -> list:
    """The KV tile ranges [(first, last), ...] of a query tile's split
    (one range without one)."""
    if kv_chunk <= 0:
        return [(lo, hi)]
    return [(a, min(hi, a + kv_chunk - 1))
            for a in range(lo, hi + 1, kv_chunk)]


def vec_copies(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel may copy by 16 bytes: head_dim a whole number of
    16-byte chunks (8 bf16 or 4 fp32 values) and q, k and v on 16-byte
    boundaries, so that every row of every head starts on one."""
    return q.shape[-1] % (16 // q.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v))


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
    (the kernel's zero-filled tails give the same result).  With a KV
    split each run of ``kv_chunk`` tiles folds from scratch and the runs
    merge in order, as the combine kernel does.  For bf16 inputs P is
    rounded to bf16 before P V, as the tensor-core kernel feeds it to the
    MMA, while the sum l takes the fp32 P."""
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
        parts = []
        lo, hi = kv_tile_range(q0, geom.bq, geom.bk, s, causal, window)
        for first, last in kv_runs(lo, hi, geom.kv_chunk):
            m = torch.full(qt.shape[:3], NEG_INF, device=q.device)
            l = torch.zeros(qt.shape[:3], device=q.device)
            acc = torch.zeros(qt.shape, device=q.device)
            for j in range(first, last + 1):
                k0 = j * geom.bk
                kt = kf[:, :, k0:k0 + geom.bk]
                vt = vf[:, :, k0:k0 + geom.bk]
                sc = torch.matmul(qt, kt.transpose(-1, -2)) * scale
                cols = torch.arange(k0, k0 + kt.shape[2],
                                    device=q.device)[None]
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
            parts.append((m, l, acc))
        if len(parts) > 1:   # the combine: weights exp(m_z - max m)
            top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            l = sum(torch.exp(m - top) * lz for m, lz, _ in parts)
            acc = sum(torch.exp(m - top)[..., None] * az
                      for m, _, az in parts)
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
    geom = kv_split(legalize(block_q, block_k, s, d, q.dtype), b * hq, s,
                    causal, window)
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
    vec = vec_copies(q, k, v)
    out = torch.empty_like(q)
    part_o = part_ml = None      # a split's partial rows, (m, l) beside
    runs = 1
    if geom.kv_chunk:
        runs = max(len(kv_runs(*kv_tile_range(t, geom.bq, geom.bk, s, causal,
                                              window), geom.kv_chunk))
                   for t in range(0, s, geom.bq))
        part_o = torch.empty((runs, b * hq, s, d), device=q.device)
        part_ml = torch.empty((runs, b * hq, s, 2), device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, k.shape[2], d, float(scale), int(bool(causal)),
            0 if window is None else int(window), _DTYPE_CODE[q.dtype],
            geom.bq, geom.bk, geom.dp, int(vec), geom.kv_chunk, runs,
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed (code {rc})"
                           f" for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype} geometry {geom}")
    flash_attention.launches += 1
    flash_attention.calls[(tuple(q.shape), k.shape[2], bool(causal), window,
                           int(block_q), int(block_k), geom.dtype)] += 1
    return out


flash_attention.launches = 0
flash_attention.calls = collections.Counter()
flash_attention.last_geometry = None


def _bind(lib) -> None:
    lib.repro_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _bind)
