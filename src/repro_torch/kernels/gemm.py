"""Tunable tiled GEMM: the Hopper kernels, their legalizer and their plain
version.

The Hopper counterpart of ``repro/kernels/gemm.py::_gemm_kernel`` (bf16
or fp32 tiles into an fp32 accumulator, cast once to ``out_dtype``), as
two CUDA kernels in ``csrc/gemm.cu``: bf16 operands run on the tensor
cores (``mma.sync`` bf16 -> fp32, tiles kept in bf16 in shared memory
behind a 3-stage ``cp.async`` ring); on an H100 they are bound by bytes
(45-212 FLOP a byte at ResNet-18's shapes, under the 295 ridge), so the
design keeps bytes in flight and every SM busy.  fp32 operands run on the
FMA pipes (IEEE fp32, as the reference's rtol 1e-5 asks), bound by the
arithmetic.

The ARCO hardware agent's knobs set the requested geometry exactly as in
the reference (``gemm_config_from_knobs`` is identical): tile_m from
BATCH x spatial tiles, tile_k from the Ci tile, tile_n from the Co tile.
Those tiles were sized for a 128 MiB TPU VMEM (block_m up to 4,096,
block_k up to 4,608), so the wrapper maps each requested ``GemmConfig``
onto one of the tile templates compiled into ``csrc/gemm.cu`` (the *run
geometry*, see :func:`legalize`) and records both on
``gemm.last_geometry``.  Where the output tiles are fewer than the card's
SMs, the run geometry also cuts K into ``split_k`` slices, whose fp32
partial tiles a second kernel sums in slice order.  ``parallel_m``/
``parallel_n`` (the TPU grid dimension semantics) are kept and recorded;
on a GPU every block runs in parallel, so they change nothing.

``gemm`` launches the CUDA kernel for CUDA tensors and counts each call
once on ``gemm.launches`` (with the split-K sum, two kernels a call).
``conv`` runs a bf16 conv as the same kernel in its implicit mode, which
gathers im2col's patch matrix from the NHWC activation in its own loads
instead of reading it from memory (:func:`implicit_ok` says which convs
it takes); it counts on ``gemm.launches`` and, as an implicit launch,
on ``gemm.implicit_launches``.  For CPU tensors, or with
``use_kernel=False``, it runs :func:`gemm_plain`, which walks the same
run geometry in PyTorch, slices included.  As in the
reference, ``out_dtype`` (fp32 or bf16) sets C's dtype, a's by default;
an fp32 product written in bf16 takes the workspace and the summing
kernel even when K is not cut, which round each sum once.

Both take an output epilogue, keyword-only: ``bias`` (N,), ``residual``
(C's shape, contiguous), both of C's dtype, and ``relu``.  Each fp32 value
of C becomes ``relu((acc + bias[col]) + residual[row, col])``, each part
only where given, as separate adds in that order, NaN kept by the ReLU,
before its one rounding to C's dtype (:func:`gemm_plain` does the same
in PyTorch): a conv's bias, its ReLU and a residual net's skip add cost
no pass of their own.  Under split-K the summing kernel applies it after
the sum.  A launch with any of the three counts on
``gemm.epilogue_launches``.

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
BK_TEMPLATES = (16, 32)        # fp32
BF16_BK_TEMPLATES = (32, 64)   # bf16: 64 or 128 bytes a tile row
BF16_STAGES = 3                # the bf16 kernel's cp.async ring
SMEM_BUDGET = 100 * 1024  # shared memory of a block: two blocks an SM
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
        bf16: BF16_STAGES stages of the A tile (bm, bk) and the B tile
        (bk, bn) in bf16, every row padded by 8 values (16 bytes)."""
        if self.dtype == "bfloat16":
            return BF16_STAGES * (self.bm * (self.bk + 8)
                                  + self.bk * (self.bn + 8)) * 2
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


def bk_templates(dtype: torch.dtype, bm: int, bn: int) -> Tuple[int, ...]:
    """The BK templates a (bm, bn) tile may run: fp32's BK_TEMPLATES;
    bf16's BF16_BK_TEMPLATES whose ring fits SMEM_BUDGET (all but 64 at
    128 x 128).  This is the one place that decides: ``csrc/gemm.cu``
    compiles every BF16_BK_TEMPLATES entry."""
    if dtype != torch.bfloat16:
        return BK_TEMPLATES
    return tuple(bk for bk in BF16_BK_TEMPLATES
                 if RunGeometry(bm, bn, bk, dtype="bfloat16").smem_bytes
                 <= SMEM_BUDGET)


def split_k_for(tiles: int, steps: int) -> int:
    """K slices for ``tiles`` output tiles of ``steps`` bk steps each: 1
    when the tiles fill the SMs; else about BLOCKS_PER_SM blocks an SM,
    with no slice under MIN_SLICE_STEPS steps.  The count is that of the
    slices :meth:`RunGeometry.k_slices` cuts, none of them empty."""
    if tiles >= _build.SM_COUNT:
        return 1
    want = min(BLOCKS_PER_SM * _build.SM_COUNT // tiles,
               steps // MIN_SLICE_STEPS)
    if want <= 1:
        return 1
    return -(-steps // -(-steps // want))


def legalize(config: GemmConfig, m: int, n: int, k: int,
             dtype: torch.dtype = torch.float32) -> RunGeometry:
    """Requested geometry -> run geometry.  As the reference clamps each
    block to its dimension (``min(block, dim)``), each run tile is the
    largest template not above ``min(requested block, dim)``; where no
    template is that small, the smallest template runs and the kernel
    masks the tail.  BK comes from :func:`bk_templates` of the dtype and
    the run tile.  K is then cut by :func:`split_k_for`, and the copies
    move 16 bytes at a time where both row strides allow it: fp32 ``K % 4
    == 0`` and ``N % 4 == 0``, bf16 ``K % 8 == 0`` and ``N % 8 == 0``."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm takes float32 or bfloat16, got {dtype}")
    bm = _pick(BM_TEMPLATES, config.block_m, m)
    bn = _pick(BN_TEMPLATES, config.block_n, n)
    bk = _pick(bk_templates(dtype, bm, bn), config.block_k, k)
    chunk = 16 // dtype.itemsize   # values in a 16-byte copy
    tiles = -(-m // bm) * -(-n // bn)
    return RunGeometry(bm=bm, bn=bn, bk=bk,
                       split_k=split_k_for(tiles, -(-k // bk)),
                       vec=k % chunk == 0 and n % chunk == 0,
                       dtype=str(dtype).removeprefix("torch."))


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
               out_dtype: Optional[torch.dtype] = None, *,
               bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None,
               relu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch over the same run geometry: one
    (bm, bn) output tile at a time; for each K slice in order, its steps
    of bk in order into an fp32 partial; the partials summed in slice
    order (the split-K sum kernel's order); tails by slicing; the
    epilogue on the tile's fp32 total (``+ bias``, broadcast over rows,
    then ``+ residual``, then ReLU, which keeps NaN); cast once to
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
            if bias is not None:
                total = total + bias[j:j + geom.bn].float()
            if residual is not None:
                total = total + residual[i:i + geom.bm, j:j + geom.bn].float()
            if relu:
                total = torch.relu(total)
            out[i:i + geom.bm, j:j + geom.bn] = total.to(out_dtype)
    return out


def check_epilogue(bias: Optional[torch.Tensor],
                   residual: Optional[torch.Tensor], shape: Tuple[int, ...],
                   dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``bias`` is None or a contiguous (shape[-1],) tensor,
    and ``residual`` None or a contiguous tensor of ``shape``, both of
    ``dtype`` on ``device``: C's shape, dtype and device."""
    for name, t, want in (("bias", bias, tuple(shape[-1:])),
                          ("residual", residual, tuple(shape))):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"the epilogue's {name} must be {dtype} (C's "
                            f"dtype), got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"the epilogue's {name} must have shape {want},"
                             f" got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"the epilogue's {name} is on {t.device}, C on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"the epilogue's {name} must be contiguous")


def _fused(bias, residual, relu) -> bool:
    return bias is not None or residual is not None or bool(relu)


def _refuse_grad(*ts: Optional[torch.Tensor]) -> None:
    # the kernel's output would carry no grad_fn: refuse, not cut
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            "the gemm kernel is forward-only (the reference kernel has no "
            "backward); call it under torch.no_grad() or on tensors that do "
            "not require grad")


def _launch(call, geom: RunGeometry, m: int, n: int, k: int,
            dtype: torch.dtype, out_dtype: torch.dtype,
            device: torch.device, fused: bool) -> torch.Tensor:
    """C (m, n) in ``out_dtype`` from ``call(c, ws, stream)``, a call of
    the library's entry given C's pointer, the workspace's (None where
    the geometry needs none) and the current stream; raises where the
    launch fails, else counts it on ``gemm.launches``, and on
    ``gemm.epilogue_launches`` where ``fused`` (it applies any epilogue)."""
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    # the slices' fp32 partials, or fp32 tiles whose C the sum writes bf16
    use_ws = geom.split_k > 1 or (dtype == torch.float32
                                  and out_dtype != dtype)
    ws = (torch.empty((geom.split_k, m, n), dtype=torch.float32,
                      device=device) if use_ws else None)
    with torch.cuda.device(device):
        rc = call(out.data_ptr(), None if ws is None else ws.data_ptr(),
                  torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed (code {rc}) for "
                           f"{(m, n, k)} {dtype} -> {out_dtype} geometry "
                           f"{geom}")
    gemm.launches += 1
    gemm.epilogue_launches += fused
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def gemm(a: torch.Tensor, b: torch.Tensor,
         config: GemmConfig = GemmConfig(),
         out_dtype: Optional[torch.dtype] = None,
         use_kernel: bool = True, *, bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None,
         relu: bool = False) -> torch.Tensor:
    """C = epilogue(A @ B). a: (M, K), b: (K, N), float32 or bfloat16; C
    in ``out_dtype`` (float32 or bfloat16; a's dtype when None); ``bias``
    (N,), ``residual`` (M, N) and ``relu`` the output epilogue (module
    docstring), checked by :func:`check_epilogue`.

    CUDA tensors go through the Hopper kernel (or raise); CPU tensors, and
    ``use_kernel=False``, take the plain version of the same geometry."""
    _check(a, b)
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm writes float32 or bfloat16, got {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    check_epilogue(bias, residual, (m, n), out_dtype, a.device)
    geom = legalize(config, m, n, k, a.dtype)
    on_kernel = a.device.type != "cpu" and use_kernel
    if on_kernel:
        _refuse_grad(a, b, bias, residual)
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
        return gemm_plain(a, b, geom, out_dtype, bias=bias,
                          residual=residual, relu=relu)
    return _launch(
        lambda c, ws, stream: _lib().repro_gemm(
            a.data_ptr(), b.data_ptr(), c, ws, m, n, k, _DTYPE_CODE[a.dtype],
            _DTYPE_CODE[out_dtype], geom.bm, geom.bn, geom.bk, geom.split_k,
            geom.slice_width(k), int(geom.vec), _ptr(bias), _ptr(residual),
            int(relu), stream),
        geom, m, n, k, a.dtype, out_dtype, a.device,
        _fused(bias, residual, relu))


gemm.launches = 0
gemm.implicit_launches = 0
gemm.epilogue_launches = 0
gemm.last_geometry = None


def implicit_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether :func:`conv` takes the conv of NHWC ``x`` by HWIO ``w``:
    both bf16 CUDA tensors on one device, contiguous, 16-byte aligned,
    with CI % 8 == 0 and CO % 8 == 0, so that each of A's 16-byte chunks
    is 8 channels of one pixel of x and B's rows are whole chunks (the
    VEC copies).  Reads only the tensors' device, dtype, shape, layout
    and address."""
    return (x.device.type == "cuda" and w.device == x.device
            and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.ndim == 4 and w.ndim == 4 and w.shape[2] == x.shape[3]
            and w.shape[2] % 8 == 0 and w.shape[3] % 8 == 0
            and x.is_contiguous() and w.is_contiguous()
            and (x.data_ptr() | w.data_ptr()) % 16 == 0)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
         config: GemmConfig = GemmConfig(), *,
         bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None,
         relu: bool = False) -> torch.Tensor:
    """The conv of NHWC ``x`` (B, H, W, CI) by HWIO ``w`` (KH, KW, CI, CO)
    as one launch of the bf16 kernel's implicit mode: the GEMM of im2col's
    (M, N, K) = (B*OH*OW, CO, KH*KW*CI) at ``legalize``'s run geometry,
    its A gathered from x in the kernel's loads, then the epilogue
    (``bias`` (CO,), ``residual`` (B, OH, OW, CO), ``relu``).
    Bit-identical to ``gemm(im2col(x), w.reshape(K, CO), config, ...)``
    with the same epilogue.  Takes what :func:`implicit_ok` accepts, else
    raises; counts on ``gemm.launches`` and ``gemm.implicit_launches``
    (and ``gemm.epilogue_launches``).  Returns (B, OH, OW, CO) in bf16."""
    if not implicit_ok(x, w):
        raise ValueError(
            f"the implicit conv takes contiguous, 16-byte aligned bf16 CUDA "
            f"tensors with CI % 8 == 0 and CO % 8 == 0, got x "
            f"{tuple(x.shape)} {x.dtype} on {x.device} and w "
            f"{tuple(w.shape)} {w.dtype}")
    _refuse_grad(x, w, bias, residual)
    b, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wd + 2 * pad - kw) // stride + 1
    if oh < 1 or ow < 1 or b < 1:
        raise ValueError(f"empty conv of {tuple(x.shape)} by {tuple(w.shape)}"
                         f" at stride {stride}, pad {pad}")
    check_epilogue(bias, residual, (b, oh, ow, co), x.dtype, x.device)
    m, n, k = b * oh * ow, co, kh * kw * ci
    geom = legalize(config, m, n, k, x.dtype)
    gemm.last_geometry = {"requested": dataclasses.asdict(config),
                          "run": dataclasses.asdict(geom)}
    out = _launch(
        lambda c, ws, stream: _lib().repro_gemm_conv(
            x.data_ptr(), w.data_ptr(), c, ws, b, h, wd, ci, co, kh, kw,
            stride, pad, _DTYPE_CODE[x.dtype], geom.bm, geom.bn, geom.bk,
            geom.split_k, geom.slice_width(k), _ptr(bias), _ptr(residual),
            int(relu), stream),
        geom, m, n, k, x.dtype, x.dtype, x.device,
        _fused(bias, residual, relu))
    gemm.implicit_launches += 1
    return out.reshape(b, oh, ow, co)


def build() -> str:
    """Compile csrc/gemm.cu for sm_90a (once per source content) and
    return the library's path."""
    return _build.build("gemm")


def _bind(lib) -> None:
    # ..., bias, residual, relu, stream
    epilogue_and_stream = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
    lib.repro_gemm.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + epilogue_and_stream)
    lib.repro_gemm.restype = ctypes.c_int
    lib.repro_gemm_conv.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + epilogue_and_stream)
    lib.repro_gemm_conv.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("gemm", _bind)
