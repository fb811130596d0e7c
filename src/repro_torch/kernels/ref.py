"""Plain PyTorch oracles for the kernels (the correctness ground truth).

Layouts follow the reference package: activations NHWC, conv weights HWIO,
attention (B, S, H, D).

Precision: a float32 product on the card must stay IEEE float32, because
the reference holds the GEMM to rtol 1e-5.  cuBLAS matmuls already default
to it (``torch.backends.cuda.matmul.allow_tf32`` is False), but cuDNN
convolutions default to TF32, which keeps about three decimal digits.
Importing this module therefore sets both switches to False.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fp32-accumulated product, cast to ``out_dtype`` (default a's)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               pad: int = 0) -> torch.Tensor:
    """x: (B, H, W, CI), w: (KH, KW, CI, CO) -> (B, OH, OW, CO), fp32."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1),
                   stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, all in fp32,
    cast once to x's dtype (the RMSNorm kernel's function)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention oracle.

    q: (B, S, HQ, D); k, v: (B, S, HKV, D). HQ % HKV == 0.
    ``window``: sliding-window size (mixtral SWA); None = full.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, s, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)
