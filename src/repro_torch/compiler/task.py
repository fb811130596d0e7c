"""``TuningTask`` — one unit of tuning work.

A task's design space appends its workload descriptor to every config's
GBT features, which is what makes cross-task cost-model transfer work: a
shared surrogate sees ``[config features ++ workload descriptor]`` rows
from every task it serves.  Conv/GEMM tasks measure through the analytical
oracle; pod-level (arch x shape) cells (:meth:`TuningTask.cell`) through
the :class:`~repro_torch.compiler.oracle.CompileOracle`; the zoo's pod
networks build their shard-space tasks with ``from_space`` over an
analytical proxy.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional

import numpy as np

from repro_torch.compiler.oracle import AnalyticalOracle, Oracle
from repro_torch.compiler.records import RecordLog
from repro_torch.core.design_space import DesignSpace


@dataclasses.dataclass(frozen=True)
class TuningTask:
    """One tuning task: a design space, a name, and how to build its oracle."""

    name: str
    space: DesignSpace
    multiplicity: int = 1           # layers sharing this workload
    # oracle_factory(task, records) -> Oracle; None = AnalyticalOracle
    oracle_factory: Optional[Callable[["TuningTask", Optional[RecordLog]],
                                      Oracle]] = None

    def make_oracle(self, records: Optional[RecordLog] = None,
                    workers: int = 0, timeout_s: Optional[float] = None,
                    executor=None, device=None) -> Oracle:
        """Build this task's oracle.  ``workers``/``timeout_s`` configure
        subprocess fan-out for expensive per-settings oracles, and
        ``executor`` is a session-shared pool (one pool serving every
        task, jobs carrying per-task specs); ``device`` places the
        analytical oracle.  A factory receives ``workers``/``timeout_s``
        and ``executor`` only if its signature takes them (or
        ``**kwargs``), as in the reference."""
        if self.oracle_factory is not None:
            params = inspect.signature(self.oracle_factory).parameters
            kw = {}
            var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
            if var_kw or "workers" in params:
                kw.update(workers=workers, timeout_s=timeout_s)
            if var_kw or "executor" in params:
                kw["executor"] = executor
            return self.oracle_factory(self, records, **kw)
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
        (pin, task): revisiting the same pin replays from cache.
        Multiplicity and the oracle factory carry over (factories build
        from ``task.space``, which is now the pinned subspace)."""
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

    @staticmethod
    def cell(arch: str, shape: str, n_devices: Optional[int] = None,
             verbose: bool = True) -> "TuningTask":
        """Pod-level (arch x shape) cell measured by the compile oracle over
        ``n_devices`` placeholder devices (default ``REPRO_DRYRUN_DEVICES``,
        else 256)."""
        from repro_torch.compiler.oracle import CompileOracle, default_devices
        from repro_torch.core.shard_space import ShardSpace
        n_devices = n_devices or default_devices()
        space = ShardSpace.for_cell(arch, shape, measure_fn=None,
                                    n_devices=n_devices)
        if not space.choices[0]:
            raise ValueError(
                f"no model-axis choice fits {n_devices} device(s); the "
                "smallest is 4 (REPRO_DRYRUN_DEVICES or n_devices)")

        def factory(task: "TuningTask", records: Optional[RecordLog],
                    workers: int = 0, timeout_s: Optional[float] = None,
                    executor=None) -> Oracle:
            # the session loop and the oracle share one space object
            return CompileOracle(arch, shape, n_devices=n_devices,
                                 task=task.name, records=records,
                                 verbose=verbose, space=task.space,
                                 workers=workers, timeout_s=timeout_s,
                                 executor=executor)

        return TuningTask(name=f"{arch}/{shape}", space=space,
                          oracle_factory=factory)
