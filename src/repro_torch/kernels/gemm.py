"""Tunable tiled GEMM: the Hopper kernel, its legalizer and its plain version.

The ARCO hardware agent's knobs set the requested geometry exactly as in
the reference (``gemm_config_from_knobs`` is identical): tile_m from
BATCH x spatial tiles, tile_k from the Ci tile, tile_n from the Co tile.
Those tiles were sized for a 128 MiB TPU VMEM (block_m up to 4,096,
block_k up to 4,608), so the wrapper maps each requested ``GemmConfig``
onto one of the tile templates compiled into ``csrc/gemm.cu`` (the *run
geometry*, see :func:`legalize`) and records both on
``gemm.last_geometry``.  ``parallel_m``/``parallel_n`` (the TPU grid
dimension semantics) are kept and recorded; on a GPU every block runs in
parallel, so they change nothing.

``gemm`` launches the CUDA kernel for CUDA tensors and counts each launch
on ``gemm.launches``.  For CPU tensors, or with ``use_kernel=False``, it
runs :func:`gemm_plain`, which walks the same run geometry in PyTorch.

The kernel is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a``, bound with ``ctypes``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref  # noqa: F401  (sets IEEE fp32 matmuls)

# Tile templates compiled into csrc/gemm.cu (256 threads a block each).
BM_TEMPLATES = (16, 32, 64, 128)
BN_TEMPLATES = (32, 64, 128)
BK_TEMPLATES = (16, 32)
SMEM_LIMIT = 48 * 1024  # static shared memory a block may use
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
    """The compiled tile template one launch runs."""
    bm: int
    bn: int
    bk: int

    @property
    def smem_bytes(self) -> int:
        """Static shared memory of the template: both tiles in fp32, the
        A tile padded by one column (see csrc/gemm.cu)."""
        return ((self.bm + 1) + self.bn) * self.bk * 4


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


def legalize(config: GemmConfig, m: int, n: int, k: int) -> RunGeometry:
    """Requested geometry -> run geometry.  As the reference clamps each
    block to its dimension (``min(block, dim)``), each run tile is the
    largest template not above ``min(requested block, dim)``; where no
    template is that small, the smallest template runs and the kernel
    masks the tail."""
    return RunGeometry(bm=_pick(BM_TEMPLATES, config.block_m, m),
                       bn=_pick(BN_TEMPLATES, config.block_n, n),
                       bk=_pick(BK_TEMPLATES, config.block_k, k))


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


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               geom: RunGeometry) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch over the same run geometry: one
    (bm, bn) output tile at a time, its K loop in order in steps of bk
    into an fp32 accumulator, tails by slicing, cast to a's dtype."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    for i in range(0, m, geom.bm):
        for j in range(0, n, geom.bn):
            acc = torch.zeros((min(geom.bm, m - i), min(geom.bn, n - j)),
                              dtype=torch.float32, device=a.device)
            for kk in range(0, k, geom.bk):
                acc += torch.matmul(a[i:i + geom.bm, kk:kk + geom.bk].float(),
                                    b[kk:kk + geom.bk, j:j + geom.bn].float())
            out[i:i + geom.bm, j:j + geom.bn] = acc.to(a.dtype)
    return out


def gemm(a: torch.Tensor, b: torch.Tensor,
         config: GemmConfig = GemmConfig(),
         use_kernel: bool = True) -> torch.Tensor:
    """C = A @ B. a: (M, K), b: (K, N), float32 or bfloat16; C in a's dtype.

    CUDA tensors go through the Hopper kernel (or raise); CPU tensors, and
    ``use_kernel=False``, take the plain version of the same geometry."""
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    geom = legalize(config, m, n, k)
    gemm.last_geometry = {"requested": dataclasses.asdict(config),
                          "run": dataclasses.asdict(geom)}
    if a.device.type == "cpu" or not use_kernel:
        return gemm_plain(a, b, geom)
    if a.device.type != "cuda":
        raise ValueError(f"gemm kernel runs on CUDA tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm kernel takes contiguous row-major operands")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().repro_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, n, k, _DTYPE_CODE[a.dtype],
                               geom.bm, geom.bn, geom.bk, stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed (code {rc}) for "
                           f"{(m, n, k)} {a.dtype} geometry {geom}")
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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_gemm.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("gemm", _bind)
