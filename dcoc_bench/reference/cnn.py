"""Plain float32 forward of the configured CNNs: the deploy cells' reference.

Written from the published networks (ResNet, arXiv:1512.03385, basic
blocks; VGG, arXiv:1409.1556, configuration D) with the departures each
configuration file states: batch norm folded into each conv's weight and
bias, as at inference; ResNet's downsampling shortcut a strided average
pool with zero channel padding (``shortcut: avgpool_zero_pad``, near the
paper's option A); the head a global average pool and one linear layer.

``F.conv2d`` in float32 with TF32 off, on NCHW tensors.  The inputs are
NHWC and the conv weights HWIO, as the harness hands them to both sides;
the reference upcasts what it is given and derives everything else.
``quant="fp8"`` rounds every conv's and the head's operands to float8
e4m3 with a per-tensor scale (amax to 448), the products still summed in
float32: the control, one precision below the bfloat16 the
configurations state.  It imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from dcoc_bench.reference.networks import conv_layers

FP8_MAX = 448.0   # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""
    amax = float(x.abs().max())
    if amax == 0.0:
        return x
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def forward(cfg: dict, conv_w: Sequence[torch.Tensor],
            conv_b: Sequence[torch.Tensor], fc_w: torch.Tensor,
            fc_b: torch.Tensor, x: torch.Tensor,
            quant: Optional[str] = None) -> torch.Tensor:
    """Logits (B, classes) in float32 of the NHWC batch ``x``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if quant not in (None, "fp8"):
        raise ValueError(f"unknown quant {quant!r}")
    q = fp8_round if quant == "fp8" else (lambda t: t)
    layers = conv_layers(cfg)

    def conv(i: int, h: torch.Tensor) -> torch.Tensor:
        w = conv_w[i].float().permute(3, 2, 0, 1)   # HWIO -> OIHW
        y = F.conv2d(q(h), q(w), stride=layers[i].stride,
                     padding=layers[i].pad)
        return y + conv_b[i].float().view(1, -1, 1, 1)

    h = x.float().permute(0, 3, 1, 2)
    if cfg["family"] == "resnet":
        st = cfg["stem"]
        h = F.max_pool2d(F.relu(conv(0, h)), st["pool_kernel"],
                         st["pool_stride"], padding=st["pool_pad"])
        i = 1
        for blocks, _ in cfg["stages"]:
            for _ in range(blocks):
                y = conv(i + 1, F.relu(conv(i, h)))
                if h.shape != y.shape:
                    s = layers[i].stride
                    h = F.avg_pool2d(h, s, s)
                    h = F.pad(h, (0, 0, 0, 0, 0, y.shape[1] - h.shape[1]))
                h = F.relu(h + y)
                i += 2
    else:
        pool = cfg["pool"]
        i = 0
        for reps, _ in cfg["stages"]:
            for _ in range(reps):
                h = F.relu(conv(i, h))
                i += 1
            h = F.max_pool2d(h, pool["kernel"], pool["stride"])
    feats = h.mean(dim=(2, 3))
    return q(feats) @ q(fc_w.float()) + fc_b.float()
