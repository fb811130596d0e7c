"""Tunable tiled GEMM: the Hopper kernel, its legalizer and its plain version.

The ARCO hardware agent's knobs set the requested geometry exactly as in
the reference (``gemm_config_from_knobs`` is identical): tile_m from
BATCH x spatial tiles, tile_k from the Ci tile, tile_n from the Co tile.
Those tiles were sized for a 128 MiB TPU VMEM (block_m up to 4,096,
block_k up to 4,608), so the wrapper maps each requested ``GemmConfig``
onto one of the tile templates compiled into ``csrc/gemm.cu`` (the *run
geometry*, see :func:`legalize`) and records both on
``gemm.last_geometry``.  Where the output tiles are fewer than the card's
SMs, the run geometry also cuts K into ``split_k`` slices (fp32), whose
partial tiles a second kernel sums in slice order.  ``parallel_m``/
``parallel_n`` (the TPU grid dimension semantics) are kept and recorded;
on a GPU every block runs in parallel, so they change nothing.

``gemm`` launches the CUDA kernel for CUDA tensors and counts each call
once on ``gemm.launches`` (with the split-K sum, two kernels a call).  For
CPU tensors, or with ``use_kernel=False``, it runs :func:`gemm_plain`,
which walks the same run geometry in PyTorch, slices included.  As in the
reference, ``out_dtype`` (fp32 or bf16) sets C's dtype, a's by default;
an fp32 product written in bf16 takes the workspace and the summing
kernel even when K is not cut, which round each sum once.

The kernel is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a``, bound with ``ctypes``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref  # noqa: F401  (sets IEEE fp32 matmuls)

# Tile templates compiled into csrc/gemm.cu.
BM_TEMPLATES = (16, 32, 64, 128)
BN_TEMPLATES = (32, 64, 128)
BK_TEMPLATES = (16, 32)
SMEM_BUDGET = 100 * 1024  # shared memory of a block: two blocks an SM
SM_COUNT = 132            # SMs of an H100 SXM, the card the kernel targets
BLOCKS_PER_SM = 2         # split-K aims at this many blocks an SM
MIN_SLICE_STEPS = 4       # no split-K slice is cut shorter (bk steps)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """Kernel geometry — the knobs ARCO tunes."""
    block_m: int = 128
    block_n: int = 128
    block_k: int = 128
    # scheduling-agent knobs (TPU grid dimension semantics)
    parallel_m: bool = True    # h_threading analog: M grid dim parallel
    parallel_n: bool = True    # oc_threading analog: N grid dim parallel


@dataclasses.dataclass(frozen=True)
class RunGeometry:
    """What one launch runs: the compiled tile template, the number of K
    slices (1: not cut), whether the copies move 16 bytes (``vec``) or
    single elements, and the operands' dtype."""
    bm: int
    bn: int
    bk: int
    split_k: int = 1
    vec: bool = False
    dtype: str = "float32"

    @property
    def smem_bytes(self) -> int:
        """Shared memory of the template (see csrc/gemm.cu).  fp32: two
        stages of the k-major A tile, rows padded by 4, and the B tile.
        bf16 (the first port's loop): both tiles once, in fp32, the A tile
        padded by one column."""
        if self.dtype == "bfloat16":
            return ((self.bm + 1) + self.bn) * self.bk * 4
        return 2 * ((self.bm + 4) + self.bn) * self.bk * 4

    def slice_width(self, k: int) -> int:
        """K a slice covers: whole bk steps, the steps shared out evenly."""
        steps = -(-k // self.bk)
        return -(-steps // self.split_k) * self.bk

    def k_slices(self, k: int) -> List[Tuple[int, int]]:
        """The K ranges of the slices, in order; the last one is shorter
        where the steps do not divide evenly."""
        width = self.slice_width(k)
        return [(k0, min(k, k0 + width)) for k0 in range(0, k, width)]


def gemm_config_from_knobs(tile_m: int, tile_n: int, tile_k: int,
                           h_threading: int, oc_threading: int) -> GemmConfig:
    """Map ARCO knob values onto a kernel geometry.

    Tile values are rounded up to hardware granules (8 sublanes / 128 lanes);
    threading>1 marks the corresponding grid dimension parallel.
    """
    rup = lambda v, g: max(g, int(-(-int(v) // g) * g))
    return GemmConfig(
        block_m=rup(tile_m, 8),
        block_n=rup(tile_n, 128),
        block_k=rup(tile_k, 128),
        parallel_m=h_threading > 1,
        parallel_n=oc_threading > 1,
    )


def _pick(templates: Tuple[int, ...], requested: int, dim: int) -> int:
    target = min(int(requested), int(dim))
    fits = [t for t in templates if t <= target]
    return max(fits) if fits else templates[0]


def split_k_for(tiles: int, steps: int) -> int:
    """K slices for ``tiles`` output tiles of ``steps`` bk steps each: 1
    when the tiles fill the SMs; else about BLOCKS_PER_SM blocks an SM,
    with no slice under MIN_SLICE_STEPS steps.  The count is that of the
    slices :meth:`RunGeometry.k_slices` cuts, none of them empty."""
    if tiles >= SM_COUNT:
        return 1
    want = min(BLOCKS_PER_SM * SM_COUNT // tiles, steps // MIN_SLICE_STEPS)
    if want <= 1:
        return 1
    return -(-steps // -(-steps // want))


def legalize(config: GemmConfig, m: int, n: int, k: int,
             dtype: torch.dtype = torch.float32) -> RunGeometry:
    """Requested geometry -> run geometry.  As the reference clamps each
    block to its dimension (``min(block, dim)``), each run tile is the
    largest template not above ``min(requested block, dim)``; where no
    template is that small, the smallest template runs and the kernel
    masks the tail.  fp32 then cuts K by :func:`split_k_for` and copies 16
    bytes at a time where both row strides allow it (``K % 4 == 0`` and
    ``N % 4 == 0``); bf16 runs the first port's loop, uncut, by single
    elements."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm takes float32 or bfloat16, got {dtype}")
    geom = RunGeometry(bm=_pick(BM_TEMPLATES, config.block_m, m),
                       bn=_pick(BN_TEMPLATES, config.block_n, n),
                       bk=_pick(BK_TEMPLATES, config.block_k, k),
                       dtype=str(dtype).removeprefix("torch."))
    if dtype == torch.bfloat16:
        return geom
    tiles = -(-m // geom.bm) * -(-n // geom.bn)
    return dataclasses.replace(
        geom, split_k=split_k_for(tiles, -(-k // geom.bk)),
        vec=k % 4 == 0 and n % 4 == 0)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad gemm shapes {tuple(a.shape)} {tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError(f"empty gemm {tuple(a.shape)} {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"gemm takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def gemm_plain(a: torch.Tensor, b: torch.Tensor, geom: RunGeometry,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch over the same run geometry: one
    (bm, bn) output tile at a time; for each K slice in order, its steps
    of bk in order into an fp32 partial; the partials summed in slice
    order (the split-K sum kernel's order); tails by slicing; cast once to
    ``out_dtype`` (a's dtype by default)."""
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or a.dtype
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    for i in range(0, m, geom.bm):
        for j in range(0, n, geom.bn):
            total = None
            for k0, k1 in geom.k_slices(k):
                acc = torch.zeros((min(geom.bm, m - i), min(geom.bn, n - j)),
                                  dtype=torch.float32, device=a.device)
                for kk in range(k0, k1, geom.bk):
                    ke = min(k1, kk + geom.bk)
                    acc += torch.matmul(a[i:i + geom.bm, kk:ke].float(),
                                        b[kk:ke, j:j + geom.bn].float())
                total = acc if total is None else total + acc
            out[i:i + geom.bm, j:j + geom.bn] = total.to(out_dtype)
    return out


def gemm(a: torch.Tensor, b: torch.Tensor,
         config: GemmConfig = GemmConfig(),
         out_dtype: Optional[torch.dtype] = None,
         use_kernel: bool = True) -> torch.Tensor:
    """C = A @ B. a: (M, K), b: (K, N), float32 or bfloat16; C in
    ``out_dtype`` (float32 or bfloat16; a's dtype when None).

    CUDA tensors go through the Hopper kernel (or raise); CPU tensors, and
    ``use_kernel=False``, take the plain version of the same geometry."""
    _check(a, b)
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm writes float32 or bfloat16, got {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    geom = legalize(config, m, n, k, a.dtype)
    on_kernel = a.device.type != "cpu" and use_kernel
    if on_kernel:
        if a.device.type != "cuda":
            raise ValueError(f"gemm kernel runs on CUDA tensors, got "
                             f"{a.device}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("gemm kernel takes contiguous row-major "
                             "operands")
        if geom.vec and (a.data_ptr() | b.data_ptr()) % 16:
            geom = dataclasses.replace(geom, vec=False)  # unaligned views
    gemm.last_geometry = {"requested": dataclasses.asdict(config),
                          "run": dataclasses.asdict(geom)}
    if not on_kernel:
        return gemm_plain(a, b, geom, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    # fp32 tiles go to the workspace where the summing kernel writes C
    use_ws = a.dtype == torch.float32 and (geom.split_k > 1
                                           or out_dtype != a.dtype)
    ws = (torch.empty((geom.split_k, m, n), dtype=torch.float32,
                      device=a.device) if use_ws else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().repro_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               None if ws is None else ws.data_ptr(),
                               m, n, k, _DTYPE_CODE[a.dtype],
                               _DTYPE_CODE[out_dtype], geom.bm,
                               geom.bn, geom.bk, geom.split_k,
                               geom.slice_width(k),
                               int(geom.vec), stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed (code {rc}) for "
                           f"{(m, n, k)} {a.dtype} -> {out_dtype} geometry "
                           f"{geom}")
    gemm.launches += 1
    return out


gemm.launches = 0
gemm.last_geometry = None


def build() -> str:
    """Compile csrc/gemm.cu for sm_90a (once per source content) and
    return the library's path."""
    return _build.build("gemm")


def _bind(lib) -> None:
    lib.repro_gemm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_gemm.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("gemm", _bind)
