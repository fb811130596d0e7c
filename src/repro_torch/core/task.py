"""Tuning-task extraction — the compiler front half.

Walks a model definition and emits one ``DesignSpace`` per convolution
layer (deduplicated by workload shape, with layer multiplicity retained so
network latency sums correctly), mirroring how TVM extracts tuning tasks
per op.  Task names (``resnet-18:conv1``) are the reference's, letter for
letter, so record files key the same rows in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.design_space import DesignSpace
from repro_torch.hw.tpu_spec import DEFAULT, TpuSpec
from repro_torch.models import specs as cnn_specs


@dataclasses.dataclass(frozen=True)
class Task:
    name: str               # representative layer name
    space: DesignSpace
    multiplicity: int       # how many layers share this workload
    layer_names: Tuple[str, ...]


def conv_tasks(model: str, batch: int = 1,
               spec: TpuSpec = DEFAULT) -> List[Task]:
    """Unique conv tuning tasks for a network (counts match Table 3 before
    dedup; dedup only merges *identical* workloads, as AutoTVM does)."""
    groups: Dict[Tuple, List[str]] = {}
    order: List[Tuple] = []
    for s in cnn_specs.conv_specs(model):
        key = tuple(sorted(s.workload(batch).items()))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(s.name)
    return [Task(name=f"{model}:{groups[key][0]}",
                 space=DesignSpace.for_conv2d(dict(key), spec),
                 multiplicity=len(groups[key]),
                 layer_names=tuple(groups[key]))
            for key in order]


def total_conv_layers(model: str) -> int:
    return len(cnn_specs.conv_specs(model))


def network_latency(tasks: List[Task], best_latency: Dict[str, float]) -> float:
    """Sum of per-layer latencies given per-task best results (seconds)."""
    return sum(best_latency[t.name] * t.multiplicity for t in tasks)


def network_flops(model: str, batch: int = 1) -> float:
    return sum(s.flops(batch) for s in cnn_specs.conv_specs(model))
