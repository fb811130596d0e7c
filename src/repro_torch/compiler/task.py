"""``TuningTask`` — one unit of tuning work.

A task's design space appends its workload descriptor to every config's
GBT features, which is what makes cross-task cost-model transfer work: a
shared surrogate sees ``[config features ++ workload descriptor]`` rows
from every task it serves.  Pod-level compile cells (``TuningTask.cell``
in the reference) wait for ROADMAP item 16; the zoo's pod networks build
their shard-space tasks with ``from_space`` over an analytical proxy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.compiler.oracle import AnalyticalOracle, Oracle
from repro_torch.compiler.records import RecordLog
from repro_torch.core.design_space import DesignSpace


@dataclasses.dataclass(frozen=True)
class TuningTask:
    """One tuning task: a design space, a name and a layer multiplicity."""

    name: str
    space: DesignSpace
    multiplicity: int = 1           # layers sharing this workload

    def make_oracle(self, records: Optional[RecordLog] = None,
                    device=None) -> Oracle:
        return AnalyticalOracle(self.space, task=self.name, records=records,
                                device=device)

    def descriptor(self) -> np.ndarray:
        """Cell-descriptor features — the workload half that
        ``space.feature_vector`` appends to every config row, which lets a
        shared GBT tell this task's measurements apart from another's."""
        return np.asarray(self.space.workload_features(), np.float32)

    def pinned(self, knob_idxs, values, tag: str) -> "TuningTask":
        """This task with knobs frozen at shared *values*
        (``DesignSpace.pin``) — e.g. one network-wide hardware config.  The
        name gains ``#tag`` so oracle caches and JSONL records key per
        (pin, task): revisiting the same pin replays from cache."""
        return dataclasses.replace(self, name=f"{self.name}#{tag}",
                                   space=self.space.pin(knob_idxs, values))

    # ---------------------------------------------------------- constructors
    @staticmethod
    def from_space(name: str, space: DesignSpace,
                   multiplicity: int = 1) -> "TuningTask":
        return TuningTask(name=name, space=space, multiplicity=multiplicity)

    @staticmethod
    def matmul(m: int, n: int, k: int,
               name: Optional[str] = None) -> "TuningTask":
        return TuningTask(name=name or f"matmul_{m}x{n}x{k}",
                          space=DesignSpace.for_matmul(m, n, k))

    @staticmethod
    def conv_tasks(model: str, batch: int = 1) -> List["TuningTask"]:
        """All unique conv tasks of a network (Table-3 extraction)."""
        from repro_torch.core.task import conv_tasks
        return [TuningTask(name=t.name, space=t.space,
                           multiplicity=t.multiplicity)
                for t in conv_tasks(model, batch=batch)]
