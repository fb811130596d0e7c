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
* ``workers=N`` fans per-settings measurements across ONE crash-isolated
  subprocess pool shared by every task, with ``timeout_s``
  per-measurement timeouts; the interleaved ARCO scheduler then overlaps
  one task's GBT refits and MAPPO updates with another's in-flight
  measurements (analytical tasks are batched and cheap — they ignore
  ``workers``);
* ``remote="host:port[,host:port]"`` fans the same measurements over TCP
  worker daemons (``python -m repro_torch.compiler.executor.worker``);
  ``executor=`` borrows a caller's executor (a server's idle slots, a
  fleet connection); the final ``Executor.stats()`` snapshot of an owned
  executor lands in ``SessionReport.executor_stats``;
* ``trace=<path>`` writes a span trace of the run (``trace_sample_rate``
  keeps that fraction of per-measurement spans); ``monitor=PORT`` (or a
  borrowed :class:`~repro_torch.obs.serve.MonitorServer`) serves live
  ``/metrics`` and ``/status``;
* ``device`` places the MAPPO nets, rollouts, the baselines' searches and
  the analytical measurements (default ``cuda``).

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
    # final Executor.stats() snapshot (jobs/failures/respawns; remote runs
    # add per-endpoint detail) — empty for in-process sessions and for
    # documents written without the field
    executor_stats: Dict[str, object] = dataclasses.field(
        default_factory=dict)

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
                "executor_stats": dict(self.executor_stats),
                "reports": {n: r.to_dict() for n, r in self.reports.items()}}

    @staticmethod
    def from_dict(d: Dict) -> "SessionReport":
        return SessionReport(
            reports={n: TuneReport.from_dict(r)
                     for n, r in d["reports"].items()},
            wall_time_s=d["wall_time_s"], algo=d["algo"],
            shared_cost_model=d["shared_cost_model"],
            budget_per_task=d["budget_per_task"],
            surrogates=d.get("surrogates", {}),
            executor_stats=d.get("executor_stats", {}))


class Session:
    """One tuning run over one or many tasks with a shared cost model."""

    def __init__(self, tasks: Union[TuningTask, Iterable[TuningTask]],
                 tuner: Optional[TunerConfig] = None, algo: str = "arco",
                 budget: Optional[int] = None, use_cs: bool = True,
                 share_cost_model: bool = True,
                 records: Union[None, str, RecordLog] = None,
                 seed: Optional[int] = None,
                 workers: int = 0, timeout_s: Optional[float] = None,
                 remote: Union[None, str, list] = None,
                 gbt: Optional[GBTModel] = None,
                 executor=None,
                 surrogates: Union[None, str, SurrogateStore] = None,
                 network: Optional[str] = None,
                 trace: Optional[str] = None,
                 monitor=None,
                 trace_sample_rate: float = 1.0,
                 device=None):
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
        if remote and workers:
            raise ValueError("remote= and workers= are mutually exclusive: "
                             "one measurement transport per session")
        if remote and executor is not None:
            raise ValueError("remote= and executor= are mutually exclusive")
        if (timeout_s is not None and not workers and not remote
                and executor is None):
            raise ValueError("timeout_s needs workers >= 1 or remote=: "
                             "in-process measurements cannot be preempted")
        self.workers = workers
        self.timeout_s = timeout_s
        self.remote = remote
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
        # tracing: ``trace=`` makes this session build its own tracer and
        # save it there after run(); without it, run() does NOT touch the
        # ambient tracer (an outer netopt trace keeps collecting)
        self.trace_path = trace
        self.trace_sample_rate = float(trace_sample_rate)
        # live monitoring: ``monitor=PORT`` starts an owned MonitorServer
        # for this run; ``monitor=MonitorServer`` is borrowed — either way
        # the session attaches a /status source + scrape-time collector
        # and finalizes it (freezing the last snapshot) before teardown.
        # Monitoring only reads session state, so reports stay identical
        # with it on vs off.
        self._monitor_arg = monitor
        self._monitor = None
        self._monitor_owned = False
        self._monitor_source = None
        self._loops = []  # live ArcoLoop list (status snapshots read it)
        self._live_reports: Dict[str, TuneReport] = {}
        self._oracles = []  # created by run(), closed in its finally
        # ONE worker pool shared by all tasks; an external executor= is the
        # caller's (outlives the session — never closed here)
        self._executor = executor
        self._own_executor = executor is None
        self.device = resolve_device(device)

    # ------------------------------------------------------ live monitoring
    def _live_progress(self):
        """Copy-on-read progress numbers for the monitor: per-task state,
        total paid measurements, and the weighted best-so-far network
        latency (defined once every task has a finite best)."""
        mult = {t.name: t.multiplicity for t in self.tasks}
        tasks: Dict[str, Dict[str, object]] = {}
        for loop in list(self._loops):
            tr = loop.track
            best = float(tr.best_lat)
            tasks[tr.task] = {
                "measurements": int(tr.count),
                "best_latency": best if best < float("inf") else None,
            }
        for name, rep in dict(self._live_reports).items():
            tasks[name] = {"measurements": int(rep.n_measurements),
                           "best_latency": float(rep.best_latency),
                           "done": True}
        total = sum(int(t["measurements"]) for t in tasks.values())
        net = None
        if tasks and all(t["best_latency"] is not None
                         for t in tasks.values()):
            net = sum(float(t["best_latency"]) * mult.get(n, 1)
                      for n, t in tasks.items())
        return tasks, total, net

    def _live_status(self) -> Dict[str, object]:
        tasks, total, net = self._live_progress()
        oracle = {"hits": 0, "misses": 0, "failures": 0}
        for o in list(self._oracles):
            st = o.stats()
            for k in oracle:
                oracle[k] += int(st.get(k, 0))
        executor = self._executor
        return {
            "kind": "session", "algo": self.algo,
            "budget_per_task": int(self.budget),
            "n_tasks": len(self.tasks),
            "measurements": total,
            "best_network_latency": net,
            "tasks": tasks,
            "oracle": oracle,
            "executor": executor.stats() if executor is not None else {},
        }

    def _collect_metrics(self, metrics) -> None:
        """Scrape-time collector: map live progress + executor stats onto
        the monitor's own registry (never the ambient tracer's)."""
        tasks, total, net = self._live_progress()
        metrics.counter("session.measurements").value = float(total)
        if net is not None:
            metrics.gauge("session.network_latency").set(net)
        executor = self._executor
        if executor is not None:
            metrics.record_executor_stats(executor.stats())

    def _make_oracle(self, task: TuningTask):
        oracle = task.make_oracle(self.records, workers=self.workers,
                                  timeout_s=self.timeout_s,
                                  executor=self._executor,
                                  device=self.device)
        self._oracles.append(oracle)
        return oracle

    # ----------------------------------------------------------------- run
    def run(self) -> SessionReport:
        tracer = (obs.Tracer(name="session",
                             sample_rate=self.trace_sample_rate)
                  if self.trace_path else None)
        scope = obs.use(tracer) if tracer is not None \
            else contextlib.nullcontext()
        if self._monitor_arg is not None:
            from repro_torch.obs.serve import coerce_monitor
            self._monitor, self._monitor_owned = \
                coerce_monitor(self._monitor_arg)
            self._monitor.start()
            self._monitor_source = self._monitor.attach(
                "session", self._live_status,
                collector=self._collect_metrics, tracer=tracer)
        try:
            with scope:
                with obs.current().span("session", cat="session",
                                        algo=self.algo):
                    return self._run()
        finally:
            if tracer is not None:
                tracer.save(self.trace_path)
            if self._monitor is not None and self._monitor_owned:
                self._monitor.stop()
                self._monitor = None

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
        if self.workers > 0 and self._executor is None:
            # one pool for the whole session — N workers total, not N per
            # task; jobs carry each oracle's own WorkerSpec.  Workers spawn
            # lazily, so this is free for tasks that never submit
            # (analytical oracles, fully-warm resumes).
            from repro_torch.compiler.executor import SubprocessExecutor
            self._executor = SubprocessExecutor(workers=self.workers,
                                                timeout_s=self.timeout_s)
        elif self.remote and self._executor is None:
            # the same over TCP: one fleet connection serving every task,
            # jobs routed to capability-compatible daemons
            from repro_torch.compiler.executor import RemoteExecutor
            self._executor = RemoteExecutor(self.remote,
                                            timeout_s=self.timeout_s)
        executor_stats: Dict[str, object] = {}
        try:
            if self.algo == "arco":
                reports = self._run_arco(shared_gbt)
            else:
                reports = self._run_baseline(shared_gbt)
        finally:
            # freeze the monitor's last snapshot FIRST, while oracles,
            # trackers and the executor are all still readable — a
            # post-run scrape then answers with final values
            if self._monitor is not None and self._monitor_source:
                self._monitor.finalize(self._monitor_source)
            for oracle in self._oracles:  # tear down any worker pools
                oracle.close()
            self._oracles = []
            if self._executor is not None and self._own_executor:
                executor_stats = self._executor.stats()
                obs.current().metrics.record_executor_stats(executor_stats)
                self._executor.close()
                self._executor = None
        for t in self.tasks:  # reports carry their task's layer weight
            reports[t.name].multiplicity = t.multiplicity
        return SessionReport(reports=reports,
                             wall_time_s=time.perf_counter() - t0,
                             algo=self.algo,
                             shared_cost_model=self.share_cost_model,
                             budget_per_task=self.budget,
                             surrogates=surrogate_stats,
                             executor_stats=executor_stats)

    def _run_arco(self, shared_gbt: Optional[GBTModel]
                  ) -> Dict[str, TuneReport]:
        """Interleaved ARCO: one iteration per task per round, every task
        refitting the same surrogate when the cost model is shared.

        Each task goes through ``step_submit``/``collect`` halves: with
        in-process oracles a batch resolves at submit time and the
        schedule is the plain one-iteration-per-task round robin, while
        executor-backed oracles leave batches in flight — the scheduler
        then runs other tasks' MAPPO/GBT work and only blocks when *all*
        remaining tasks are waiting on measurements.
        """
        loops = []
        for t in self.tasks:
            with obs.current().span("task-init", cat="session", task=t.name):
                loops.append(ArcoLoop(
                    t.space, self.cfg, oracle=self._make_oracle(t),
                    gbt=shared_gbt if shared_gbt is not None else GBTModel(
                        n_rounds=self.cfg.gbt_rounds, seed=self.cfg.seed),
                    use_cs=self.use_cs, task=t.name, device=self.device))
        self._loops = loops  # live-status snapshots read the trackers
        # Seed all tasks first, collecting (and refitting) in task order;
        # the seed batches of all tasks share the worker pool.
        for loop in loops:
            loop.seed_submit(self.budget)
        for loop in loops:
            loop.collect(block=True)
        active = list(loops)
        while active:
            progressed = False
            for loop in list(active):
                if loop.has_pending:
                    if not loop.collect(block=False):
                        continue  # still measuring; run the other tasks
                    progressed = True
                if loop.exhausted or loop.track.count >= self.budget:
                    active.remove(loop)
                    progressed = True
                    continue
                if loop.step_submit(self.budget):
                    progressed = True
                    if loop.pending_ready():
                        # in-process oracle: finish the iteration now, so
                        # the schedule matches the synchronous loop exactly
                        loop.collect(block=True)
                else:
                    active.remove(loop)
                    progressed = True
            if not progressed and active:
                # every remaining task is waiting on the oracle — block on
                # the first one instead of spinning
                next(l for l in active if l.has_pending).collect(block=True)
        return {t.name: loop.report() for t, loop in zip(self.tasks, loops)}

    def _run_baseline(self, shared_gbt: Optional[GBTModel]
                      ) -> Dict[str, TuneReport]:
        """Baselines run sequentially per task; the GBT-based ones still
        share the surrogate across tasks when the cost model is shared
        (their ``oracle.measure`` calls still fan each *batch* across the
        worker pool when the oracle is executor-backed)."""
        from repro_torch.core import baselines as B
        self._live_reports.clear()
        reports = self._live_reports  # filled per task; /status reads it
        for t in self.tasks:
            oracle = self._make_oracle(t)
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
