"""Typed, JSON-serializable tuning results + shared loop bookkeeping.

Every tuner emits a ``TuneReport``; ``to_dict``/``from_dict`` round-trip it
through JSON, in the same shape as the reference's reports.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.design_space import DesignSpace
from repro_torch.hw import analytical


@dataclasses.dataclass
class TuneReport:
    """Result of tuning one task."""

    task: str
    best_config: List[int]              # per-knob choice indices
    best_latency: float
    n_measurements: int
    wall_time_s: float
    # rows: (measurement_count, best_latency_so_far, wall_time)
    history: List[Tuple[int, float, float]]
    # every measurement in order: (measurement_index, latency)
    measurements: List[Tuple[int, float]]
    best_settings: Optional[Dict[str, object]] = None  # decoded knob values
    oracle_stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    # layers sharing this workload (from TuningTask.multiplicity) — what
    # SessionReport.network_latency() weights per-task bests by
    multiplicity: int = 1

    def best_gflops(self, space: DesignSpace) -> float:
        if space.kind == "conv2d":
            return analytical.conv2d_gflops(space.workload, self.best_latency)
        m, n, k = (space.workload[d] for d in "mnk")
        return 2.0 * m * n * k / self.best_latency / 1e9

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["best_config"] = [int(x) for x in self.best_config]
        d["history"] = [list(r) for r in self.history]
        d["measurements"] = [list(r) for r in self.measurements]
        return d

    @staticmethod
    def from_dict(d: Dict) -> "TuneReport":
        fields = {f.name for f in dataclasses.fields(TuneReport)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["history"] = [tuple(r) for r in kw.get("history", [])]
        kw["measurements"] = [tuple(r) for r in kw.get("measurements", [])]
        return TuneReport(**kw)


class Tracker:
    """Per-task loop bookkeeping: budget counting, best-so-far, convergence
    history, and the already-proposed set (``seen``).  Value memoization
    lives in the Oracle — this only dedups *proposals* within one run."""

    def __init__(self, task: str = ""):
        self.task = task
        self.t0 = time.perf_counter()
        self.best_lat = np.inf
        self.best_cfg: Optional[np.ndarray] = None
        self.count = 0
        self.history: List[Tuple[int, float, float]] = []
        self.measurements: List[Tuple[int, float]] = []
        self.seen: Set[Tuple[int, ...]] = set()
        # Interleaved multi-task sessions account per-task *active* time via
        # add_active(); None = sequential wall-clock mode (since t0).
        self.active_s: Optional[float] = None

    def is_new(self, config) -> bool:
        return tuple(int(x) for x in config) not in self.seen

    def add_active(self, dt: float) -> None:
        self.active_s = (self.active_s or 0.0) + dt

    def _elapsed(self) -> float:
        if self.active_s is not None:
            return self.active_s
        return time.perf_counter() - self.t0

    def record(self, configs: np.ndarray, lats: np.ndarray) -> None:
        for cfg, lat in zip(configs, lats):
            self.count += 1
            self.seen.add(tuple(int(x) for x in cfg))
            self.measurements.append((self.count, float(lat)))
            if lat < self.best_lat:
                self.best_lat = float(lat)
                self.best_cfg = np.asarray(cfg)
        self.history.append((self.count, self.best_lat, self._elapsed()))

    def report(self, oracle=None,
               best_settings: Optional[Dict[str, object]] = None
               ) -> TuneReport:
        stats = oracle.stats() if oracle is not None else {}
        best = ([] if self.best_cfg is None
                else [int(x) for x in self.best_cfg])
        return TuneReport(
            task=self.task, best_config=best, best_latency=self.best_lat,
            n_measurements=self.count, wall_time_s=self._elapsed(),
            history=list(self.history), measurements=list(self.measurements),
            best_settings=best_settings, oracle_stats=stats)
