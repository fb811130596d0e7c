"""Fused RMSNorm: the Hopper kernel, its run geometry and its plain version.

``rmsnorm(x, w)`` computes ``x * rsqrt(mean(x^2) + eps) * w`` over the last
axis in fp32 and casts once to x's dtype, as the reference's Pallas kernel
does (the reference's jnp ``layers.rmsnorm`` multiplies in x's dtype
instead; the port follows the kernel, so the two differ by rounding in
bf16 and agree in fp32).

For CUDA tensors it launches ``csrc/rmsnorm.cu`` (the row in registers,
spread over warps for few rows, one warp a row for many, 16-byte copies
where alignment allows)
and counts the launch on ``rmsnorm.launches``; :func:`legalize` chooses
that run geometry.  For CPU tensors, or with ``use_kernel=False``, it runs
:func:`rmsnorm_plain`, which walks the reference's (block_rows, d) row
tiles.  ``block_rows`` is the reference's knob: recorded on
``rmsnorm.last_geometry`` beside the run geometry, and it never changes
the result (rows are independent).

Training differentiates through it: where grad mode is on and an operand
requires grad, :func:`rmsnorm` goes through an autograd Function whose
forward is the same kernel launch and whose backward is the analytic
gradient in plain PyTorch (:func:`rmsnorm_backward`), since the
reference has no backward kernel for the norm.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

WARP = 32
WARPS_PER_ROW = 8              # warps a row at most
VEC_SLOTS = (1, 2, 4, 6, 8)    # 16-byte chunks a lane: the vector templates
SCALAR_SLOTS = 32              # values a lane holds in the scalar template
ROWS_PER_BLOCK = 4             # rows a block where a row is one warp
SM_THREADS, SM_BLOCKS = 2048, 32   # resident on one sm_90 SM at most
SPREAD_ROWS = 2 * _build.SM_COUNT  # up to these rows, a row spreads over warps
MAX_D = WARP * WARPS_PER_ROW * SCALAR_SLOTS   # 8192: any template holds it
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class RunGeometry(NamedTuple):
    """What one launch runs: ``threads`` lanes a row (32 x warps a row),
    each holding ``slots`` copies of the row's values in registers, a copy
    16 bytes (``vec``) or one value; blocks of ``rows_per_block`` rows;
    ``grid`` blocks, which walk the rows in steps of
    ``grid x rows_per_block``."""
    rows_per_block: int
    threads: int
    vec: bool
    slots: int
    grid: int

    @property
    def warps_per_row(self) -> int:
        return self.threads // WARP


def vector_width(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in one 16-byte copy (4 fp32, 8 bf16)."""
    return 16 // dtype.itemsize


@functools.lru_cache(maxsize=None)
def _row_layout(d: int, dtype: torch.dtype, aligned: bool,
                spread: bool) -> tuple[int, bool, int]:
    """(threads a row, 16-byte copies, slots a lane) of a row of d."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {dtype}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm kernel takes 1 <= d <= {MAX_D}, got {d}")
    vec = aligned and d % vector_width(dtype) == 0
    copies = d // vector_width(dtype) if vec else d
    per_lane = 1 if spread else VEC_SLOTS[-1] if vec else SCALAR_SLOTS
    threads = WARP * min(WARPS_PER_ROW, -(-copies // (WARP * per_lane)))
    slots = (next(n for n in VEC_SLOTS if n * threads >= copies) if vec
             else SCALAR_SLOTS)
    return threads, vec, slots


def legalize(d: int, rows: int, dtype: torch.dtype = torch.float32,
             aligned: bool = True) -> RunGeometry:
    """The run geometry of ``rows`` rows of ``d`` values of ``dtype``.

    - 16-byte copies where the operands are 16-byte ``aligned`` and d is a
      multiple of a copy's values (4 fp32, 8 bf16); else the scalar
      template, SCALAR_SLOTS values a lane.
    - Warps a row, two layouts (cached per d and dtype).  Up to
      SPREAD_ROWS rows (two blocks an SM), a launch waits on the chain a
      warp runs after its one load, so a row spreads over the warps that
      give each lane one copy, up to WARPS_PER_ROW.  Past that, bytes
      govern, so a row takes the fewest warps whose lanes hold it in at
      most VEC_SLOTS[-1] copies (SCALAR_SLOTS values) a lane.  Then the
      fewest VEC_SLOTS that hold the row.  qwen2's d 1536, bf16: a decode
      step's 8 rows 6 warps a row, a copy a lane; a 1,006-row prefill one
      warp a row, 6 copies a lane (fp32: 8 warps and 2, then 2 warps and
      6).
    - Rows a block: ROWS_PER_BLOCK where a row is one warp, else one (the
      block's warps meet in one shared-memory step).
    - Grid: a block for each rows_per_block rows, capped at
      ``_build.SM_COUNT`` times the blocks resident on an SM; the kernel's
      row loop walks what the cap leaves.
    """
    threads, vec, slots = _row_layout(d, dtype, aligned, rows <= SPREAD_ROWS)
    rpb = min(ROWS_PER_BLOCK, rows) if threads == WARP else 1
    cap = _build.SM_COUNT * min(SM_BLOCKS, SM_THREADS // (rpb * threads))
    return RunGeometry(rows_per_block=rpb, threads=threads, vec=vec,
                       slots=slots, grid=min(-(-rows // rpb), cap))


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
    at a time, as the reference's grid walks them (on the ``meta`` device,
    which holds no values, all rows at once)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    rows = x2.shape[0]
    step = max(1, min(int(block_rows), rows))
    if x.device.type == "meta":
        step = max(rows, 1)
    out = torch.empty_like(x2)
    for i in range(0, rows, step):
        out[i:i + step] = ref.rmsnorm_ref(x2[i:i + step], w, eps)
    return out.reshape(shape)


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6) -> tuple:
    """The analytic gradient of the kernel's function ``y = x r w``, with
    ``r = rsqrt(mean(x^2) + eps)`` recomputed from x, in fp32:
    ``dx = r (g w - x r^2 mean(g w x))`` and ``dw = sum_rows g x r``, cast
    to x's and w's dtypes.  Plain PyTorch: the reference has no backward
    kernel for RMSNorm (its model differentiates jnp code)."""
    d = x.shape[-1]
    xf, gw = x.float().reshape(-1, d), (g.float() * w.float()).reshape(-1, d)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dx = r * (gw - xf * r.square() * (gw * xf).mean(dim=-1, keepdim=True))
    dw = (g.float().reshape(-1, d) * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


class _RMSNormFunction(torch.autograd.Function):
    """The kernel (or, for CPU tensors, its plain version) forward and
    :func:`rmsnorm_backward` backward; saves x and w, nothing else."""

    @staticmethod
    def forward(ctx, x, w, eps, block_rows):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _forward(x, w, eps, block_rows, True)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, w, g, ctx.eps)
        return dx, dw, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            block_rows: int = 128, use_kernel: bool = True) -> torch.Tensor:
    """x: (..., d), w: (d,), float32 or bfloat16; the result in x's dtype.

    CUDA tensors go through the Hopper kernel (or raise); CPU tensors, and
    ``use_kernel=False``, take the plain version.  Differentiable: where
    grad mode is on and x or w requires grad, the call goes through an
    autograd Function whose forward is the same launch (counted the same)
    and whose backward is :func:`rmsnorm_backward`; with
    ``use_kernel=False`` autograd differentiates the plain version."""
    _check(x, w)
    if (use_kernel and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return _RMSNormFunction.apply(x, w, eps, block_rows)
    return _forward(x, w, eps, block_rows, use_kernel)


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float, block_rows: int,
             use_kernel: bool) -> torch.Tensor:
    d = x.shape[-1]
    rows = x.numel() // d
    dev = x.device
    on_kernel = dev.type != "cpu" and use_kernel
    aligned = True
    if on_kernel:
        if dev.type != "cuda":
            raise ValueError(f"rmsnorm kernel runs on CUDA tensors, got {dev}")
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("rmsnorm kernel takes contiguous operands")
        out = torch.empty_like(x)
        ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
        aligned = not (ptrs[0] | ptrs[1] | ptrs[2]) % 16
    geom = legalize(d, rows, x.dtype, aligned)
    rmsnorm.last_geometry = {"requested": {"block_rows": int(block_rows)},
                             "run": geom._asdict()}
    if not on_kernel:
        return rmsnorm_plain(x, w, eps, block_rows)
    # the raw current stream: torch.cuda.current_stream() builds a Stream
    # object, several microseconds a call on a path that makes 57 a step
    args = (*ptrs, rows, d, float(eps), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[w.dtype], int(geom.vec), geom.warps_per_row,
            geom.slots, geom.rows_per_block, geom.grid,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = _lib().repro_rmsnorm(*args)
    else:
        with torch.cuda.device(dev):
            rc = _lib().repro_rmsnorm(*args)
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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_rmsnorm.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("rmsnorm", _bind)
