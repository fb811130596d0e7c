"""Tuning sessions: ARCO over one or many tasks with a shared cost model.

A :class:`Session` runs ARCO over :class:`~repro_torch.compiler.task.TuningTask`\\ s:

* every measurement routes through one memoizing, record-persisting
  :class:`~repro_torch.compiler.oracle.Oracle` per task;
* with ``share_cost_model=True`` (default) all tasks feed **one** GBT
  surrogate — cross-task transfer via the cell-descriptor half of the
  feature vector;
* ``records=<path.jsonl>`` persists every measurement and resumes warm,
  in files interchangeable with the reference package's;
* ``trace=<path>`` writes a span trace of the run;
* ``device`` places the MAPPO nets, rollouts and analytical measurements
  (default ``cuda``).

The reference's surrogate store, measurement workers, remote fabric, live
monitor and baseline algorithms belong to later slices of the port; asking
for them raises ``NotImplementedError`` instead of being ignored.

Quickstart::

    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    rep = Session(TuningTask.conv_tasks("resnet-18")[:3], budget=128,
                  records="artifacts/r18.jsonl").run()
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterable, Optional, Union

from repro_torch import obs, resolve_device
from repro_torch.compiler.records import RecordLog
from repro_torch.compiler.report import TuneReport
from repro_torch.compiler.task import TuningTask
from repro_torch.core.cost_model import GBTModel
from repro_torch.core.tuner import ArcoLoop, TunerConfig

ALGOS = ("arco",)
# what the reference's Session offers that a later slice of the port brings
_LATER = {
    "random": "slice 2 (core/baselines.py)",
    "autotvm": "slice 2 (core/baselines.py)",
    "chameleon": "slice 2 (core/baselines.py)",
    "surrogates": "slice 2 (compiler/surrogate_store.py)",
    "workers": "slice 3 (the measurement fabric)",
    "remote": "slice 3 (the measurement fabric)",
    "executor": "slice 3 (the measurement fabric)",
    "monitor": "slice 3 (obs/serve.py with the measurement fabric)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {_LATER[what]} of the "
        f"PyTorch port")


@dataclasses.dataclass
class SessionReport:
    """Typed result of one session: per-task reports + run metadata."""

    reports: Dict[str, TuneReport]
    wall_time_s: float
    algo: str
    shared_cost_model: bool
    budget_per_task: int

    @property
    def single(self) -> TuneReport:
        """The sole report of a single-task session."""
        if len(self.reports) != 1:
            raise ValueError(f"session tuned {len(self.reports)} tasks; "
                             "use report['name']")
        return next(iter(self.reports.values()))

    def __getitem__(self, name: str) -> TuneReport:
        return self.reports[name]

    def __iter__(self):
        return iter(self.reports.values())

    def network_latency(self) -> float:
        """End-to-end network latency: per-task bests weighted by each
        task's layer multiplicity."""
        return sum(r.best_latency * r.multiplicity
                   for r in self.reports.values())

    def to_dict(self) -> Dict:
        return {"algo": self.algo, "shared_cost_model": self.shared_cost_model,
                "budget_per_task": self.budget_per_task,
                "wall_time_s": self.wall_time_s,
                "reports": {n: r.to_dict() for n, r in self.reports.items()}}

    @staticmethod
    def from_dict(d: Dict) -> "SessionReport":
        return SessionReport(
            reports={n: TuneReport.from_dict(r)
                     for n, r in d["reports"].items()},
            wall_time_s=d["wall_time_s"], algo=d["algo"],
            shared_cost_model=d["shared_cost_model"],
            budget_per_task=d["budget_per_task"])


class Session:
    """One tuning run over one or many tasks with a shared cost model."""

    def __init__(self, tasks: Union[TuningTask, Iterable[TuningTask]],
                 tuner: Optional[TunerConfig] = None, algo: str = "arco",
                 budget: Optional[int] = None, use_cs: bool = True,
                 share_cost_model: bool = True,
                 records: Union[None, str, RecordLog] = None,
                 seed: Optional[int] = None,
                 trace: Optional[str] = None,
                 device=None,
                 surrogates=None, workers: int = 0, remote=None,
                 executor=None, monitor=None):
        if workers:
            raise _later("workers")
        for name, value in (("surrogates", surrogates), ("remote", remote),
                            ("executor", executor), ("monitor", monitor)):
            if value is not None:  # monitor=0 asks for an ephemeral port
                raise _later(name)
        if algo in _LATER:
            raise _later(algo)
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; have {ALGOS}")
        if isinstance(tasks, TuningTask):
            tasks = [tasks]
        self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("Session needs at least one task")
        names = [t.name for t in self.tasks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate task names: {names}")
        cfg = tuner or TunerConfig()
        if seed is not None:
            cfg = dataclasses.replace(cfg, seed=seed)
        self.cfg = cfg
        self.algo = algo
        self.budget = budget or cfg.iteration_opt * cfg.b_measure
        self.use_cs = use_cs
        self.share_cost_model = share_cost_model
        self.records = (RecordLog(records) if isinstance(records, str)
                        else records)
        self.trace_path = trace
        self.device = resolve_device(device)

    # ----------------------------------------------------------------- run
    def run(self) -> SessionReport:
        # no trace requested -> leave the ambient tracer alone
        tracer = obs.Tracer(name="session") if self.trace_path else None
        scope = obs.use(tracer) if tracer is not None \
            else contextlib.nullcontext()
        try:
            with scope:
                with obs.current().span("session", cat="session",
                                        algo=self.algo):
                    return self._run()
        finally:
            if tracer is not None:
                tracer.save(self.trace_path)

    def _run(self) -> SessionReport:
        t0 = time.perf_counter()
        shared_gbt = (GBTModel(n_rounds=self.cfg.gbt_rounds)
                      if self.share_cost_model else None)
        oracles = [t.make_oracle(self.records, device=self.device)
                   for t in self.tasks]
        try:
            reports = self._run_arco(shared_gbt, oracles)
        finally:
            for oracle in oracles:
                oracle.close()
        for t in self.tasks:  # reports carry their task's layer weight
            reports[t.name].multiplicity = t.multiplicity
        return SessionReport(reports=reports,
                             wall_time_s=time.perf_counter() - t0,
                             algo=self.algo,
                             shared_cost_model=self.share_cost_model,
                             budget_per_task=self.budget)

    def _run_arco(self, shared_gbt: Optional[GBTModel], oracles
                  ) -> Dict[str, TuneReport]:
        """Interleaved ARCO: one iteration per task per round, every task
        refitting the same surrogate when the cost model is shared.  The
        analytical oracle resolves each batch at submit time, so every
        ``step_submit`` is collected at once."""
        loops = [
            ArcoLoop(t.space, self.cfg, oracle=oracle,
                     gbt=shared_gbt if shared_gbt is not None else GBTModel(
                         n_rounds=self.cfg.gbt_rounds),
                     use_cs=self.use_cs, task=t.name, device=self.device)
            for t, oracle in zip(self.tasks, oracles)]
        # Seed all tasks first, collecting (and refitting) in task order.
        for loop in loops:
            loop.seed_submit(self.budget)
        for loop in loops:
            loop.collect(block=True)
        active = list(loops)
        while active:
            for loop in list(active):
                if (loop.exhausted or loop.track.count >= self.budget
                        or not loop.step_submit(self.budget)):
                    active.remove(loop)
                    continue
                loop.collect(block=True)
        return {t.name: loop.report() for t, loop in zip(self.tasks, loops)}
