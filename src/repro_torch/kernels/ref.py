"""Plain PyTorch oracles for the kernels (the correctness ground truth).

Layouts follow the reference package: activations NHWC, conv weights HWIO.

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
