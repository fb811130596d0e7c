"""Runnable NHWC forward pass of the paper's CNNs, conv layers on the GEMM.

Every conv layer runs on the tunable GEMM (``kernels.ops.conv2d``): in bf16
on the card, where the channels allow it (all but a first conv of 3), as
the GEMM's implicit mode, which gathers the patches itself; otherwise as
im2col + the GEMM.  Each conv's bias, its ReLU and ResNet's skip add run
in the GEMM's output epilogue, on the fp32 sum before its one rounding,
so they cost no pass over the activations.  So a tuned configuration is
deployable on the model:
``apply`` takes one ``GemmConfig`` per conv layer, the output of ARCO
tuning.  Parameters live in a :class:`CNN` module; ``params_from_jax``
loads the reference's ``init_params`` tree (converted to numpy) so both
packages compute the same network.  The spec tables are in
:mod:`repro_torch.models.specs`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import GemmConfig
from repro_torch.models.specs import (MODELS, RESNET_BLOCKS, VGG_STAGES,
                                      ConvSpec, conv_specs,
                                      expected_task_count)

__all__ = ["CNN", "ConvSpec", "MODELS", "apply", "conv_specs",
           "expected_task_count", "init_params", "params_from_jax"]


class CNN(nn.Module):
    """Parameters of one network: conv weights HWIO + biases, and the
    global-average-pool -> linear classifier head."""

    def __init__(self, model: str, conv_w: List[torch.Tensor],
                 conv_b: List[torch.Tensor], fc_w: torch.Tensor,
                 fc_b: torch.Tensor):
        super().__init__()
        self.model = model.lower()
        self.conv_w = nn.ParameterList(conv_w)
        self.conv_b = nn.ParameterList(conv_b)
        self.fc_w = nn.Parameter(fc_w)
        self.fc_b = nn.Parameter(fc_b)

    def forward(self, x: torch.Tensor,
                configs: Optional[List[GemmConfig]] = None,
                use_kernel: bool = True) -> torch.Tensor:
        return apply(self, x, configs, use_kernel)


def init_params(seed: int, model: str, num_classes: int = 1000,
                device=None) -> CNN:
    """He-normal conv weights, zero biases, seeded from ``seed`` (drawn on
    the CPU so the weights do not depend on the device)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    specs = conv_specs(model)
    conv_w = [torch.randn((s.kh, s.kw, s.ci, s.co), generator=g)
              * math.sqrt(2.0 / (s.kh * s.kw * s.ci)) for s in specs]
    conv_b = [torch.zeros(s.co) for s in specs]
    co = specs[-1].co
    fc_w = torch.randn((co, num_classes), generator=g) * math.sqrt(1.0 / co)
    fc_b = torch.zeros(num_classes)
    with torch.no_grad():
        return CNN(model, conv_w, conv_b, fc_w, fc_b).to(dev)


def params_from_jax(tree: Dict, model: str, device=None) -> CNN:
    """The reference's ``init_params`` tree, leaves as numpy arrays."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return CNN(model, [t(c["w"]) for c in tree["convs"]],
               [t(c["b"]) for c in tree["convs"]],
               t(tree["fc"]["w"]), t(tree["fc"]["b"])).to(dev)


def _nchw(f, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """Run a pooling op written for NCHW on an NHWC tensor."""
    return f(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def apply(params: CNN, x: torch.Tensor,
          configs: Optional[List[GemmConfig]] = None,
          use_kernel: bool = True) -> torch.Tensor:
    """Forward pass, x: (B, H, W, 3) -> logits (B, classes).  ``configs``
    optionally supplies a tuned GEMM geometry per conv layer."""
    model = params.model
    specs = conv_specs(model)
    configs = configs or [GemmConfig()] * len(specs)

    def conv(i, x, spec, residual=None):
        """relu(conv + bias (+ residual)), all in the GEMM's epilogue."""
        return ops.conv2d(x, params.conv_w[i], spec.stride, spec.pad,
                          configs[i], use_kernel, bias=params.conv_b[i],
                          residual=residual, relu=True)

    # max pools pad with -inf, as the reference's reduce_window
    if model == "alexnet":
        pool_after = {0, 1, 4}
        for i, s in enumerate(specs):
            x = conv(i, x, s)
            if i in pool_after:
                x = _nchw(F.max_pool2d, x, 3, 2)
    elif model in VGG_STAGES:
        i = 0
        for reps in VGG_STAGES[model]:
            for _ in range(reps):
                x = conv(i, x, specs[i])
                i += 1
            x = _nchw(F.max_pool2d, x, 2, 2)
    else:  # resnet
        x = conv(0, x, specs[0])
        x = _nchw(F.max_pool2d, x, 3, 2, padding=1)
        i = 1
        for reps in RESNET_BLOCKS[model]:
            for _ in range(reps):
                sa, sb = specs[i], specs[i + 1]
                y = conv(i, x, sa)
                # the skip, added in block b's epilogue: the block's input,
                # or where b's output (y's map, as b is 3x3 at stride 1, by
                # sb.co channels) differs, its strided 1x1 average, padded
                if x.shape != (*y.shape[:3], sb.co):
                    x = _nchw(F.avg_pool2d, x, sa.stride, sa.stride)
                    x = F.pad(x, (0, sb.co - x.shape[-1]))
                x = conv(i + 1, y, sb, residual=x.contiguous())
                i += 2
    x = x.mean(dim=(1, 2))
    return x @ params.fc_w + params.fc_b
