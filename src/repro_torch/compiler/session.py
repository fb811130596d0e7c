"""Tuning sessions — ARCO or a baseline over one or many tasks.

A :class:`Session` runs ARCO or any baseline over
:class:`~repro_torch.compiler.task.TuningTask`\\ s:

* every measurement routes through one memoizing, record-persisting
  :class:`~repro_torch.compiler.oracle.Oracle` per task;
* with ``share_cost_model=True`` (default) all tasks feed **one** GBT
  surrogate — cross-task transfer via the cell-descriptor half of the
  feature vector; ``gbt=`` shares an external one (netopt shares one
  software GBT across every hardware candidate's session);
* ``records=<path.jsonl>`` persists every measurement and resumes warm,
  in files interchangeable with the reference package's;
* ``surrogates=<store.jsonl>`` persists the GBT *training rows*
  (:class:`~repro_torch.compiler.surrogate_store.SurrogateStore`) and
  warm-starts the shared GBT from other networks' rows;
* ``trace=<path>`` writes a span trace of the run;
* ``device`` places the MAPPO nets, rollouts, the baselines' searches and
  the analytical measurements (default ``cuda``).

The reference's measurement workers, remote fabric and live monitor
belong to the measurement fabric (ROADMAP Queue 1, item 14); asking for
them raises ``NotImplementedError`` instead of being ignored.

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
from repro_torch.compiler.surrogate_store import (SurrogateStore,
                                                  attach_sw_gbt, coerce_store,
                                                  space_family)
from repro_torch.compiler.task import TuningTask
from repro_torch.core.cost_model import GBTModel
from repro_torch.core.tuner import ArcoLoop, TunerConfig

ALGOS = ("arco", "random", "autotvm", "chameleon")


def measurement_fabric_later(what: str) -> NotImplementedError:
    """The error for an option of the reference's measurement fabric."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with slice 3 of the PyTorch "
        f"port, the measurement fabric (ROADMAP Queue 1, item 14)")


@dataclasses.dataclass
class SessionReport:
    """Typed result of one session: per-task reports + run metadata."""

    reports: Dict[str, TuneReport]
    wall_time_s: float
    algo: str
    shared_cost_model: bool
    budget_per_task: int
    # cross-task surrogate transfer (compiler/surrogate_store.py):
    # {"store": path, "readonly": bool, "warm_sw_rows": int} — empty on
    # sessions run without a store
    surrogates: Dict[str, object] = dataclasses.field(default_factory=dict)

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

    def total_best_latency(self,
                           multiplicity: Optional[Dict[str, int]] = None
                           ) -> float:
        """Sum of per-task best latencies (optionally layer-weighted)."""
        mult = multiplicity or {}
        return sum(r.best_latency * mult.get(name, 1)
                   for name, r in self.reports.items())

    def network_latency(self) -> float:
        """End-to-end network latency: per-task bests weighted by each
        task's layer multiplicity."""
        return sum(r.best_latency * r.multiplicity
                   for r in self.reports.values())

    def to_dict(self) -> Dict:
        return {"algo": self.algo, "shared_cost_model": self.shared_cost_model,
                "budget_per_task": self.budget_per_task,
                "wall_time_s": self.wall_time_s,
                "surrogates": dict(self.surrogates),
                "reports": {n: r.to_dict() for n, r in self.reports.items()}}

    @staticmethod
    def from_dict(d: Dict) -> "SessionReport":
        return SessionReport(
            reports={n: TuneReport.from_dict(r)
                     for n, r in d["reports"].items()},
            wall_time_s=d["wall_time_s"], algo=d["algo"],
            shared_cost_model=d["shared_cost_model"],
            budget_per_task=d["budget_per_task"],
            surrogates=d.get("surrogates", {}))


class Session:
    """One tuning run over one or many tasks with a shared cost model."""

    def __init__(self, tasks: Union[TuningTask, Iterable[TuningTask]],
                 tuner: Optional[TunerConfig] = None, algo: str = "arco",
                 budget: Optional[int] = None, use_cs: bool = True,
                 share_cost_model: bool = True,
                 records: Union[None, str, RecordLog] = None,
                 seed: Optional[int] = None,
                 gbt: Optional[GBTModel] = None,
                 surrogates: Union[None, str, SurrogateStore] = None,
                 network: Optional[str] = None,
                 trace: Optional[str] = None,
                 device=None,
                 workers: int = 0, timeout_s: Optional[float] = None,
                 remote=None, executor=None, monitor=None):
        if workers:
            raise measurement_fabric_later("workers")
        for name, value in (("timeout_s", timeout_s), ("remote", remote),
                            ("executor", executor), ("monitor", monitor)):
            if value is not None:  # monitor=0 asks for an ephemeral port
                raise measurement_fabric_later(name)
        if isinstance(tasks, TuningTask):
            tasks = [tasks]
        self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("Session needs at least one task")
        names = [t.name for t in self.tasks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate task names: {names}")
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; have {ALGOS}")
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
        # an externally supplied cost model is shared across this session's
        # tasks AND whoever else holds it
        self.gbt = gbt
        # surrogate store: the ``network`` label keys the own-rows
        # exclusion — pass the SAME name a netopt run of these tasks would
        # use (the CLI passes the zoo network name); the default label is
        # the joined task names
        self.surrogates = coerce_store(surrogates)
        self.surrogate_network = network or \
            ",".join(t.name for t in self.tasks)[:120]
        if self.surrogates is not None:
            if gbt is not None:
                raise ValueError(
                    "surrogates= with an external gbt= is ambiguous — the "
                    "gbt's owner (e.g. netopt) manages the store itself")
            if not share_cost_model:
                raise ValueError("surrogates= needs share_cost_model=True "
                                 "(transfer targets the shared GBT)")
            families = {space_family(t.space) for t in self.tasks}
            if len(families) > 1:
                # rows are stamped with ONE family; a mixed session would
                # mislabel half of them and poison later warm starts
                raise ValueError("surrogates= needs tasks of one space "
                                 f"family, got {sorted(families)}")
        self.trace_path = trace
        self.device = resolve_device(device)

    # ----------------------------------------------------------------- run
    def run(self) -> SessionReport:
        # no trace requested -> leave the ambient tracer alone (an outer
        # netopt trace keeps collecting through this session)
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
        surrogate_stats: Dict[str, object] = {}
        if self.surrogates is not None:
            # rows saved here are excluded when the same network
            # warm-starts later (its own measurements replay via records)
            shared_gbt, surrogate_stats = attach_sw_gbt(
                self.surrogates, n_rounds=self.cfg.gbt_rounds,
                seed=self.cfg.seed, network=self.surrogate_network,
                family=space_family(self.tasks[0].space))
        else:
            shared_gbt = self.gbt if self.gbt is not None else (
                GBTModel(n_rounds=self.cfg.gbt_rounds, seed=self.cfg.seed)
                if self.share_cost_model else None)
        oracles = [t.make_oracle(self.records, device=self.device)
                   for t in self.tasks]
        try:
            if self.algo == "arco":
                reports = self._run_arco(shared_gbt, oracles)
            else:
                reports = self._run_baseline(shared_gbt, oracles)
        finally:
            for oracle in oracles:
                oracle.close()
        for t in self.tasks:  # reports carry their task's layer weight
            reports[t.name].multiplicity = t.multiplicity
        return SessionReport(reports=reports,
                             wall_time_s=time.perf_counter() - t0,
                             algo=self.algo,
                             shared_cost_model=self.share_cost_model,
                             budget_per_task=self.budget,
                             surrogates=surrogate_stats)

    def _run_arco(self, shared_gbt: Optional[GBTModel], oracles
                  ) -> Dict[str, TuneReport]:
        """Interleaved ARCO: one iteration per task per round, every task
        refitting the same surrogate when the cost model is shared.  The
        analytical oracle resolves each batch at submit time, so every
        ``step_submit`` is collected at once."""
        loops = [
            ArcoLoop(t.space, self.cfg, oracle=oracle,
                     gbt=shared_gbt if shared_gbt is not None else GBTModel(
                         n_rounds=self.cfg.gbt_rounds, seed=self.cfg.seed),
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

    def _run_baseline(self, shared_gbt: Optional[GBTModel], oracles
                      ) -> Dict[str, TuneReport]:
        """Baselines run sequentially per task; the GBT-based ones still
        share the surrogate across tasks when the cost model is shared."""
        from repro_torch.core import baselines as B
        reports: Dict[str, TuneReport] = {}
        for t, oracle in zip(self.tasks, oracles):
            kw = dict(cfg=self.cfg, budget=self.budget, oracle=oracle,
                      task=t.name, device=self.device)
            if self.algo == "random":
                reports[t.name] = B.random_tune(t.space, **kw)
            elif self.algo == "autotvm":
                reports[t.name] = B.autotvm_tune(t.space, gbt=shared_gbt,
                                                 **kw)
            else:
                reports[t.name] = B.chameleon_tune(t.space, gbt=shared_gbt,
                                                   **kw)
        return reports
