"""Fused RMSNorm: the Hopper kernel, its run geometry and its plain version.

``rmsnorm(x, w)`` computes ``x * rsqrt(mean(x^2) + eps) * w`` over the last
axis in fp32 and casts once to x's dtype, as the reference's Pallas kernel
does (the reference's jnp ``layers.rmsnorm`` multiplies in x's dtype
instead; the port follows the kernel, so the two differ by rounding in
bf16 and agree in fp32).

For CUDA tensors it launches ``csrc/rmsnorm.cu`` (one thread block a row,
the row in registers) and counts the launch on ``rmsnorm.launches``.  For
CPU tensors, or with ``use_kernel=False``, it runs :func:`rmsnorm_plain`,
which walks the reference's (block_rows, d) row tiles.  ``block_rows`` is
the reference's knob: recorded on ``rmsnorm.last_geometry`` beside the run
geometry, and it never changes the result (rows are independent).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, ref

THREADS = 256
VPT_TEMPLATES = (1, 2, 4, 8, 16, 32)  # values per thread, in csrc/rmsnorm.cu
MAX_D = THREADS * VPT_TEMPLATES[-1]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class RunGeometry:
    """The compiled template one launch runs: one row per block of
    ``threads`` threads, each holding ``vpt`` values of the row."""
    rows_per_block: int
    threads: int
    vpt: int


def legalize(d: int) -> RunGeometry:
    """The smallest values-per-thread template that holds a row of d."""
    if d > MAX_D:
        raise ValueError(f"rmsnorm kernel takes d <= {MAX_D}, got {d}")
    vpt = next(v for v in VPT_TEMPLATES if v * THREADS >= d)
    return RunGeometry(rows_per_block=1, threads=THREADS, vpt=vpt)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim < 1 or w.ndim != 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"bad rmsnorm shapes {tuple(x.shape)} "
                         f"{tuple(w.shape)}")
    if x.numel() == 0:
        raise ValueError(f"empty rmsnorm input {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype} "
                        f"and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                  block_rows: int = 128) -> torch.Tensor:
    """The kernel's function in PyTorch, one (block_rows, d) tile of rows
    at a time, as the reference's grid walks them."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    rows = x2.shape[0]
    step = max(1, min(int(block_rows), rows))
    out = torch.empty_like(x2)
    for i in range(0, rows, step):
        out[i:i + step] = ref.rmsnorm_ref(x2[i:i + step], w, eps)
    return out.reshape(shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            block_rows: int = 128, use_kernel: bool = True) -> torch.Tensor:
    """x: (..., d), w: (d,), float32 or bfloat16; the result in x's dtype.

    CUDA tensors go through the Hopper kernel (or raise); CPU tensors, and
    ``use_kernel=False``, take the plain version."""
    _check(x, w)
    d = x.shape[-1]
    geom = legalize(d)
    rmsnorm.last_geometry = {"requested": {"block_rows": int(block_rows)},
                             "run": dataclasses.asdict(geom)}
    if x.device.type == "cpu" or not use_kernel:
        return rmsnorm_plain(x, w, eps, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm kernel runs on CUDA tensors, got "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous operands")
    rows = x.numel() // d
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().repro_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  rows, d, float(eps), _DTYPE_CODE[x.dtype],
                                  _DTYPE_CODE[w.dtype], geom.vpt, stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc}) for "
                           f"rows={rows} d={d} {x.dtype}/{w.dtype} {geom}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
rmsnorm.last_geometry = None


def _bind(lib) -> None:
    lib.repro_rmsnorm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_rmsnorm.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("rmsnorm", _bind)
