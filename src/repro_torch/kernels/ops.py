"""Public wrappers around the kernels: matmul, im2col, conv2d, attention.

Each takes ``use_kernel`` (default True), the counterpart of the
reference's ``use_pallas``: True routes through the kernel's wrapper
(:func:`repro_torch.kernels.gemm.gemm`,
:func:`repro_torch.kernels.flash_attention.flash_attention`: the Hopper
kernel on CUDA tensors, its plain version on CPU tensors); False runs the
plain oracle in :mod:`repro_torch.kernels.ref`.  ``conv2d`` gives a bf16
conv on the card, where :func:`repro_torch.kernels.gemm.implicit_ok`
holds, to the GEMM's implicit mode (:func:`repro_torch.kernels.gemm.conv`),
and only the others to ``im2col`` + the GEMM.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import gemm as G
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import GemmConfig, gemm, gemm_config_from_knobs


def matmul(a: torch.Tensor, b: torch.Tensor,
           config: GemmConfig = GemmConfig(),
           use_kernel: bool = True) -> torch.Tensor:
    if not use_kernel:
        return ref.matmul_ref(a, b)
    return gemm(a, b, config)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int
           ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """x: (B, H, W, CI) -> patches (B*OH*OW, KH*KW*CI), plus (OH, OW).

    Feature ordering matches ``w.reshape(KH*KW*CI, CO)`` for HWIO weights.
    """
    b, _, _, ci = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    # (B, OH, OW, CI, KH, KW): unfold appends the window dims after CI —
    # reorder features to (KH, KW, CI) to match HWIO weight flattening.
    patches = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    oh, ow = patches.shape[1], patches.shape[2]
    patches = patches.permute(0, 1, 2, 4, 5, 3)
    return patches.reshape(b * oh * ow, kh * kw * ci), (oh, ow)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
           config: GemmConfig = GemmConfig(),
           use_kernel: bool = True, *, bias: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """Conv on the tunable GEMM core. x: NHWC, w: HWIO; then the GEMM's
    epilogue: ``+ bias`` (CO,), ``+ residual`` (the output's shape,
    contiguous), ReLU, both of x's dtype (:func:`gemm.check_epilogue`).

    Where :func:`gemm.implicit_ok` holds (bf16 CUDA tensors, contiguous
    and aligned, CI and CO multiples of 8), the GEMM gathers the patches
    in its own loads (:func:`gemm.conv`); every other conv (a first conv
    of 3 channels, fp32, CPU tensors) runs as im2col + the GEMM.  Both
    give the same bits at the same ``config``, the epilogue applied to the
    fp32 sum before its one rounding.  ``use_kernel=False`` applies it in
    plain PyTorch to the reference conv's output."""
    if use_kernel and G.implicit_ok(x, w):   # it checks the epilogue
        return G.conv(x, w, stride, pad, config, bias=bias,
                      residual=residual, relu=relu)
    b, h, wd, _ = x.shape
    kh, kw, ci, co = w.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wd + 2 * pad - kw) // stride + 1
    # the residual's NHWC shape, which the GEMM's (M, N) view would hide
    G.check_epilogue(bias, residual, (b, oh, ow, co), x.dtype, x.device)
    if not use_kernel:
        out = ref.conv2d_ref(x, w, stride, pad)
        if bias is not None:
            out = out + bias
        if residual is not None:
            out = out + residual
        return F.relu(out) if relu else out
    patches, _ = im2col(x, kh, kw, stride, pad)
    out = gemm(patches, w.reshape(kh * kw * ci, co), config, bias=bias,
               residual=None if residual is None else residual.view(-1, co),
               relu=relu)
    return out.reshape(b, oh, ow, co)


def conv2d_from_knobs(x, w, stride, pad, *, tile_b, tile_h, tile_w,
                      tile_ci, tile_co, h_threading, oc_threading,
                      use_kernel: bool = True):
    """Execute a conv with an ARCO configuration (knob values)."""
    kh, kw = w.shape[0], w.shape[1]
    cfg = gemm_config_from_knobs(
        tile_m=tile_b * tile_h * tile_w,
        tile_n=tile_co,
        tile_k=tile_ci * kh * kw,
        h_threading=h_threading, oc_threading=oc_threading)
    return conv2d(x, w, stride, pad, cfg, use_kernel)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              block_q: int = 128, block_k: int = 128,
              use_kernel: bool = True) -> torch.Tensor:
    """GQA attention. q: (B, S, HQ, D); k, v: (B, S, HKV, D)."""
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)
