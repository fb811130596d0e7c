"""The paper's evaluation networks as per-layer conv workloads.

``conv_specs(name)`` lists the conv layers ARCO tunes; the layer counts
reproduce Table 3 exactly (AlexNet 5, VGG-11 8, VGG-13 10, VGG-16 13,
VGG-19 16, ResNet-18 17, ResNet-34 33 convolution tasks; ResNet downsample
skips are not convs, as in the paper's task extraction).  This module
imports no kernel, so task extraction (``core.task``) does not pull the
deploy path in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

MODELS = ("alexnet", "vgg-11", "vgg-13", "vgg-16", "vgg-19",
          "resnet-18", "resnet-34")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    h: int
    w: int
    ci: int
    co: int
    kh: int
    kw: int
    stride: int
    pad: int

    def workload(self, batch: int = 1) -> Dict[str, int]:
        return dict(b=batch, h=self.h, w=self.w, ci=self.ci, co=self.co,
                    kh=self.kh, kw=self.kw, stride=self.stride, pad=self.pad)

    def out_hw(self) -> Tuple[int, int]:
        oh = (self.h + 2 * self.pad - self.kh) // self.stride + 1
        ow = (self.w + 2 * self.pad - self.kw) // self.stride + 1
        return oh, ow

    def flops(self, batch: int = 1) -> float:
        oh, ow = self.out_hw()
        return 2.0 * batch * oh * ow * self.co * self.ci * self.kh * self.kw


VGG_STAGES = {
    "vgg-11": (1, 1, 2, 2, 2),
    "vgg-13": (2, 2, 2, 2, 2),
    "vgg-16": (2, 2, 3, 3, 3),
    "vgg-19": (2, 2, 4, 4, 4),
}
_VGG_CH = (64, 128, 256, 512, 512)

RESNET_BLOCKS = {"resnet-18": (2, 2, 2, 2), "resnet-34": (3, 4, 6, 3)}
_RESNET_CH = (64, 128, 256, 512)


def conv_specs(model: str) -> List[ConvSpec]:
    model = model.lower()
    specs: List[ConvSpec] = []
    if model == "alexnet":
        specs = [
            ConvSpec("conv1", 224, 224, 3, 64, 11, 11, 4, 2),
            ConvSpec("conv2", 27, 27, 64, 192, 5, 5, 1, 2),
            ConvSpec("conv3", 13, 13, 192, 384, 3, 3, 1, 1),
            ConvSpec("conv4", 13, 13, 384, 256, 3, 3, 1, 1),
            ConvSpec("conv5", 13, 13, 256, 256, 3, 3, 1, 1),
        ]
    elif model in VGG_STAGES:
        h, ci = 224, 3
        i = 0
        for reps, co in zip(VGG_STAGES[model], _VGG_CH):
            for _ in range(reps):
                i += 1
                specs.append(ConvSpec(f"conv{i}", h, h, ci, co, 3, 3, 1, 1))
                ci = co
            h //= 2  # maxpool 2x2/2 after each stage
    elif model in RESNET_BLOCKS:
        specs.append(ConvSpec("conv1", 224, 224, 3, 64, 7, 7, 2, 3))
        h, ci = 56, 64  # after maxpool 3x3/2
        i = 1
        for stage, (reps, co) in enumerate(zip(RESNET_BLOCKS[model],
                                               _RESNET_CH)):
            for r in range(reps):
                stride = 2 if (stage > 0 and r == 0) else 1
                i += 1
                specs.append(ConvSpec(f"conv{i}a", h, h, ci, co, 3, 3,
                                      stride, 1))
                h_out = h // stride
                specs.append(ConvSpec(f"conv{i}b", h_out, h_out, co, co,
                                      3, 3, 1, 1))
                ci, h = co, h_out
    else:
        raise ValueError(f"unknown model {model!r}; one of {MODELS}")
    return specs


def expected_task_count(model: str) -> int:
    """Table 3 'Number of Convolution Tasks'."""
    return {"alexnet": 5, "vgg-11": 8, "vgg-13": 10, "vgg-16": 13,
            "vgg-19": 16, "resnet-18": 17, "resnet-34": 33}[model.lower()]
