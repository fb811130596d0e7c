"""The conv layers of a configuration, worked out from its file of sizes.

A configuration file (``dcoc_bench/configs/<name>.json``) states a
network the way its paper does: a family (``resnet`` basic blocks or
``vgg`` stages), the stem, the stages as ``[blocks, channels]`` pairs, the
input size and the classes.  :func:`conv_layers` lists every conv layer it
implies, in forward order, under the names the tuner's task extraction
uses (``conv1``, ``conv2a``, ... for ResNet; ``conv1`` ... ``conv13`` for
VGG), so the tuning records key the same layers.  Plain Python: the
reference forward, the analytical reference and the roofline all read it,
and it imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    h: int          # input height (= width)
    ci: int
    co: int
    k: int          # square kernel
    stride: int
    pad: int

    @property
    def out(self) -> int:
        return (self.h + 2 * self.pad - self.k) // self.stride + 1

    def gemm_dims(self, batch: int) -> Tuple[int, int, int]:
        """(M, N, K) of the conv as im2col + GEMM at ``batch``."""
        return batch * self.out * self.out, self.co, self.ci * self.k ** 2

    def flops(self, batch: int) -> float:
        m, n, k = self.gemm_dims(batch)
        return 2.0 * m * n * k

    def workload(self, batch: int) -> Dict[str, int]:
        """The analytical model's workload dict of this layer."""
        return dict(b=batch, h=self.h, w=self.h, ci=self.ci, co=self.co,
                    kh=self.k, kw=self.k, stride=self.stride, pad=self.pad)


def conv_layers(cfg: dict) -> List[Conv]:
    """Every conv layer of the configuration ``cfg``, in forward order."""
    size, ci = int(cfg["image_size"]), int(cfg["in_channels"])
    out: List[Conv] = []
    if cfg["family"] == "resnet":
        st = cfg["stem"]
        stem = Conv("conv1", size, ci, st["channels"], st["kernel"],
                    st["stride"], st["pad"])
        out.append(stem)
        h = (stem.out + 2 * st["pool_pad"] - st["pool_kernel"]) \
            // st["pool_stride"] + 1
        ci = st["channels"]
        i = 1
        for s, (blocks, co) in enumerate(cfg["stages"]):
            for r in range(blocks):
                stride = 2 if s > 0 and r == 0 else 1
                i += 1
                a = Conv(f"conv{i}a", h, ci, co, 3, stride, 1)
                out.append(a)
                out.append(Conv(f"conv{i}b", a.out, co, co, 3, 1, 1))
                h, ci = a.out, co
    elif cfg["family"] == "vgg":
        cv, pool = cfg["conv"], cfg["pool"]
        h, i = size, 0
        for reps, co in cfg["stages"]:
            for _ in range(reps):
                i += 1
                c = Conv(f"conv{i}", h, ci, co, cv["kernel"], cv["stride"],
                         cv["pad"])
                out.append(c)
                h, ci = c.out, co
            h = (h - pool["kernel"]) // pool["stride"] + 1
    else:
        raise ValueError(f"unknown family {cfg['family']!r}")
    return out


def head_dims(cfg: dict) -> Tuple[int, int]:
    """(features, classes) of the global-average-pool + linear head."""
    return int(cfg["stages"][-1][1]), int(cfg["num_classes"])


def network_flops(cfg: dict, batch: int) -> float:
    """Operations of one forward at ``batch``: every conv's GEMM and the
    head's linear layer (2 a multiply-add)."""
    c, classes = head_dims(cfg)
    return (sum(layer.flops(batch) for layer in conv_layers(cfg))
            + 2.0 * batch * c * classes)


def tasks(cfg: dict, batch: int) -> List[Tuple[str, Conv, int, List[str]]]:
    """Unique conv workloads, as a tuner extracts tasks: (task name,
    the first layer of the shape, layers sharing it, their names).  The
    task name is ``<model>:<first layer>``."""
    groups: Dict[Tuple, List[Conv]] = {}
    for layer in conv_layers(cfg):
        key = tuple(sorted(layer.workload(batch).items()))
        groups.setdefault(key, []).append(layer)
    return [(f"{cfg['model']}:{ls[0].name}", ls[0], len(ls),
             [x.name for x in ls]) for ls in groups.values()]
