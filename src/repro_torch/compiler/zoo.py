"""Workload zoo — typed, named networks for network-scope tuning.

The netopt co-optimizer was born on a single ResNet-18 example; the zoo
gives it (and transfer across networks) scenario diversity: classic conv
backbones, a depthwise-separable stack, a transformer GEMM stack, and a
pod-level :class:`~repro_torch.core.shard_space.ShardSpace` network — all
as plain lists of :class:`~repro_torch.compiler.task.TuningTask`\\ s, so
every surface (``Session``, ``netopt``, the CLI) runs any of them
unchanged.  The networks, task names, multiplicities and the pod proxy are
the reference's.

    from repro_torch.compiler.zoo import get_network, network_names
    net = get_network("mobilenet-dw")
    rep = NetworkCoOptimizer(net.tasks, cfg, name=net.name).run()

CLI: ``python -m repro_torch.compiler.cli netopt --network mobilenet-dw``.

The pod-cell network measures through a deterministic *analytical proxy*
(roofline-style step-time model over the sharding knobs) so the zoo stays
cheap enough for tests and smoke runs; swap ``TuningTask.cell`` in for
cells measured by the compile oracle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

from repro_torch.compiler.task import TuningTask
from repro_torch.core.design_space import DesignSpace

__all__ = ["NetworkTask", "ZOO", "get_network", "network_names"]


@dataclasses.dataclass(frozen=True)
class NetworkTask:
    """One named network: an ordered list of tuning tasks with layer
    multiplicities — the unit ``netopt`` co-optimizes one chip for."""

    name: str
    kind: str                       # "conv" | "gemm" | "mixed" | "pod"
    description: str
    tasks: Tuple[TuningTask, ...]

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def n_layers(self) -> int:
        return sum(t.multiplicity for t in self.tasks)

    def summary(self) -> str:
        return (f"{self.name} [{self.kind}]: {self.n_tasks} unique tasks / "
                f"{self.n_layers} layers — {self.description}")


# ---------------------------------------------------------------- builders

def _conv(name: str, wl: Dict[str, int], mult: int) -> TuningTask:
    return TuningTask.from_space(name, DesignSpace.for_conv2d(wl),
                                 multiplicity=mult)


def _resnet18() -> NetworkTask:
    return NetworkTask(
        name="resnet-18", kind="conv",
        description="ResNet-18 conv backbone (Table-3 task extraction)",
        tasks=tuple(TuningTask.conv_tasks("resnet-18")))


def _vgg_stack() -> NetworkTask:
    return NetworkTask(
        name="vgg-11", kind="conv",
        description="VGG-11 3x3 conv stack (large-Ci/Co, stride-1)",
        tasks=tuple(TuningTask.conv_tasks("vgg-11")))


def _mobilenet_dw() -> NetworkTask:
    """MobileNet-v1-style depthwise-separable stack.  The analytical model
    has no grouped convolution, so a depthwise 3x3 over C channels is
    expressed as its FLOP-equivalent single-input-channel conv
    (ci=1, co=C) — the tiny-Ci regime that stresses a shared tile_ci very
    differently from ResNet/VGG, paired with 1x1 pointwise convs."""
    def dw(h: int, c: int, stride: int) -> Dict[str, int]:
        return dict(b=1, h=h, w=h, ci=1, co=c, kh=3, kw=3,
                    stride=stride, pad=1)

    def pw(h: int, ci: int, co: int) -> Dict[str, int]:
        return dict(b=1, h=h, w=h, ci=ci, co=co, kh=1, kw=1,
                    stride=1, pad=0)

    t = [
        _conv("mb:conv1", dict(b=1, h=224, w=224, ci=3, co=32, kh=3, kw=3,
                               stride=2, pad=1), 1),
        _conv("mb:dw112", dw(112, 32, 1), 1),
        _conv("mb:pw112", pw(112, 32, 64), 1),
        _conv("mb:dw56", dw(56, 128, 1), 2),
        _conv("mb:pw56", pw(56, 128, 128), 2),
        _conv("mb:dw28", dw(28, 256, 1), 2),
        _conv("mb:pw28", pw(28, 256, 256), 2),
        _conv("mb:dw14", dw(14, 512, 1), 5),
        _conv("mb:pw14", pw(14, 512, 512), 5),
        _conv("mb:pw7", pw(7, 512, 1024), 2),
    ]
    return NetworkTask(
        name="mobilenet-dw", kind="conv",
        description="MobileNet-style depthwise-separable stack "
                    "(FLOP-equivalent dw as ci=1 conv + 1x1 pointwise)",
        tasks=tuple(t))


def _bert_gemm() -> NetworkTask:
    """BERT-base-style encoder as its GEMM stack at seq 128: per block
    4 projection GEMMs (QKV + output) and the two FFN GEMMs, 12 blocks."""
    def gemm(name: str, m: int, n: int, k: int, mult: int) -> TuningTask:
        return TuningTask.from_space(name, DesignSpace.for_matmul(m, n, k),
                                     multiplicity=mult)

    t = [
        gemm("bert:proj", 128, 768, 768, 4 * 12),   # Q, K, V, out x 12
        gemm("bert:ffn_up", 128, 3072, 768, 12),
        gemm("bert:ffn_down", 128, 768, 3072, 12),
        gemm("bert:pool", 128, 768, 768, 1),
    ]
    return NetworkTask(
        name="bert-gemm", kind="gemm",
        description="BERT-base encoder GEMM stack (seq 128): QKV/out "
                    "projections + FFN up/down over 12 blocks",
        tasks=tuple(t))


def _resnet_bert() -> NetworkTask:
    """Mixed conv-front + GEMM-tail network — the heterogeneous-partition
    scenario: the ResNet-18 backbone's large-spatial convs and the BERT
    GEMM stack want different chip geometries (conv layers lean on
    spatial M-tiling with moderate Ci, the transformer GEMMs on deep
    K/N tiles), so a K=2 pipeline cut between the halves can beat any
    single shared chip end-to-end.  ``BENCH_hetero.json`` runs netopt
    K=1 vs K=2 vs the genetic baseline on (a truncation of) this network
    in the reference package."""
    front = list(TuningTask.conv_tasks("resnet-18"))
    tail = list(_bert_gemm().tasks)
    return NetworkTask(
        name="resnet-bert", kind="mixed",
        description="ResNet-18 conv front + BERT GEMM tail — the K-chip "
                    "partitioning scenario (no single chip wins both "
                    "halves)",
        tasks=tuple(front + tail))


# ------------------------------------------------------------ pod network

def pod_proxy_measure(n_layers: int, d_model: int, seq: int, batch: int,
                      n_devices: int, train: bool
                      ) -> Callable[[Dict[str, object]], float]:
    """Deterministic roofline-style step-time proxy for one LM cell —
    compute/collective/HBM terms over the sharding knobs, with hinge
    penalties for HBM overflow.  Shaped like the real dry-run estimator
    (TP helps until collectives dominate; remat trades FLOPs for memory;
    micro-batching trades overhead for residency) but runs in
    microseconds, which is what keeps the zoo's pod network usable in
    tests and CI."""
    PEAK = 180e12          # per-device matmul FLOP/s
    NET_BW = 60e9          # per-link interconnect bytes/s
    HBM = 32e9             # per-device bytes
    flops = 8.0 * n_layers * d_model * d_model * seq * batch
    if train:
        flops *= 3.0       # fwd + bwd
    p_bytes = 14.0 * n_layers * d_model * d_model * 2.0   # bf16 params
    act_bytes = 2.0 * n_layers * seq * batch * d_model * 6.0

    def measure(s: Dict[str, object]) -> float:
        tp = float(s["model_axis"])
        dp = max(n_devices / tp, 1.0)
        micro = float(s["grad_accum"])
        remat = bool(s["remat"])
        fsdp = bool(s["fsdp"])
        sp = bool(s["sequence_parallel"])
        chunk = float(s["attn_chunk"])
        mom = 4.0 if s["moment_dtype"] == "float32" else 2.0

        t_comp = flops / (n_devices * PEAK)
        if remat:
            t_comp *= 4.0 / 3.0            # recompute the forward
        # TP collectives: two all-reduces of the activation slab per layer,
        # cheaper with sequence parallelism (reduce-scatter halves volume)
        act_slab = 2.0 * seq * batch / dp * d_model
        t_tp = (0.0 if tp <= 1 else
                2.0 * n_layers * act_slab * 2.0 * (tp - 1) / tp
                / (NET_BW * (2.0 if sp else 1.0)))
        # DP gradient sync once per step, amortized over micro-batches
        t_dp = p_bytes / tp * 2.0 * (dp - 1) / dp / NET_BW / micro if train \
            else 0.0
        # attention blocking sweet spot: chunk ~ seq/8
        t_attn = t_comp * 0.05 * abs(_log2(chunk) - _log2(max(seq / 8, 1)))
        per_step = t_comp + t_tp + t_dp + t_attn + 0.002 * micro

        # memory feasibility (hinge, not a cliff: the surrogate must see
        # the gradient toward feasibility)
        shard = tp * (dp if fsdp else 1.0)
        resident = p_bytes * (1.0 + (2.0 + mom if train else 0.0)) / shard
        resident += act_bytes / tp / micro / (4.0 if remat else 1.0) \
            / (2.0 if sp else 1.0)
        over = max(resident / HBM - 1.0, 0.0)
        return per_step * (1.0 + 10.0 * over)

    return measure


def _log2(x: float) -> float:
    return math.log2(max(x, 1e-9))


def _pod_network(name: str, arch: str, n_devices: int) -> NetworkTask:
    """A pod-level network: the train/prefill/decode cells of one LM arch
    as ShardSpace tasks under the analytical proxy oracle.  netopt over
    this network searches one shared pod geometry (model-axis degree,
    moment dtype, FSDP — the ShardSpace "hardware" knobs) across all
    three cells.  Unlike the conv networks (whose analytical optimum tends to
    sit at the largest feasible geometry — a guaranteed seed), the pod
    optimum is *interior* (TP collectives punish over-sharding), so the
    outer search genuinely has to find it — which is what makes pod
    networks the interesting transfer pair."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.shard_space import ShardSpace
    cfg = get_config(arch)
    tasks: List[TuningTask] = []
    # decode cells dominate serving traffic; weight them accordingly
    for shape_name, mult in (("train_4k", 1), ("prefill_32k", 2),
                             ("decode_32k", 4)):
        cell = SHAPES[shape_name]
        fn = pod_proxy_measure(cfg.n_layers, cfg.d_model, cell.seq,
                               cell.global_batch, n_devices,
                               train=cell.kind == "train")
        space = ShardSpace.for_cell(arch, shape_name, measure_fn=fn,
                                    n_devices=n_devices)
        tasks.append(TuningTask.from_space(f"pod:{arch}/{shape_name}",
                                           space, multiplicity=mult))
    return NetworkTask(
        name=name, kind="pod",
        description=f"{arch} train/prefill/decode ShardSpace cells on a "
                    f"{n_devices}-device pod (analytical proxy oracle)",
        tasks=tuple(tasks))


def _pod_cells() -> NetworkTask:
    return _pod_network("pod-cells", "qwen2-1.5b", 256)


def _pod_cells_4b() -> NetworkTask:
    return _pod_network("pod-cells-4b", "qwen1.5-4b", 256)


# ---------------------------------------------------------------- registry

ZOO: Dict[str, Callable[[], NetworkTask]] = {
    "resnet-18": _resnet18,
    "vgg-11": _vgg_stack,
    "mobilenet-dw": _mobilenet_dw,
    "bert-gemm": _bert_gemm,
    "resnet-bert": _resnet_bert,
    "pod-cells": _pod_cells,
    "pod-cells-4b": _pod_cells_4b,
}


def network_names() -> Tuple[str, ...]:
    return tuple(ZOO)


def get_network(name: str) -> NetworkTask:
    if name not in ZOO:
        raise KeyError(f"unknown zoo network {name!r}; have "
                       f"{sorted(ZOO)}")
    net = ZOO[name]()
    names = [t.name for t in net.tasks]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate task names in {name}")
    return net
