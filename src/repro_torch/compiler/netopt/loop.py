"""Network-scope HW/SW co-optimization — the paper's actual claim.

A small set of K accelerator configurations serves the whole DNN while
per-layer software agents map every layer onto its assigned chip.  The
outer loop proposes :class:`~repro_torch.compiler.netopt.partition.
HwPartition` candidates — contiguous pipeline cuts plus one hw value-tuple
per stage (K=1 is the single shared chip) — scored by a network-scope GBT
with Confidence Sampling picking which candidates to pay for.  The inner
loop evaluates one partition by pinning every layer's hardware knobs to its
stage's values (``DesignSpace.pin``) and running the per-layer software
agents as one interleaved :class:`~repro_torch.compiler.session.Session` —
shared software GBT across layers *and* across candidates, per-(hw,
layer[, segment]) JSONL records so a revisited candidate (the refinement
pass, a resumed run) replays from cache.  A candidate's reward is the
pipeline-aware end-to-end latency: the slowest stage's
multiplicity-weighted layer sum plus the inter-stage ICI transfer — for
K=1, the plain multiplicity-weighted network latency.

Contrast with deploying each layer's own optimum, which gives every conv
layer its own fictional chip.

``surrogates=`` (a :class:`~repro_torch.compiler.surrogate_store.
SurrogateStore` or path) makes the run part of an *accumulating* system:
both GBTs warm-start from other networks' stored training rows and save
their own rows for future runs, in stores shared with the reference
package.

``workers=N`` measures every (candidate, layer) of executor-backed tasks
on one crash-isolated :class:`~repro_torch.compiler.executor.
SubprocessExecutor` pool, ``remote=`` on worker daemons (endpoints, or a
caller-owned ``RemoteExecutor`` that is borrowed, never closed);
``monitor=`` serves live ``/metrics`` and ``/status`` and
``trace_sample_rate`` thins a ``trace=`` run's per-measurement spans.

The outer search, the partition space and the numpy draws are the
reference's; every inner session runs on ``device`` (default ``cuda``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs as obslib
from repro_torch import resolve_device
from repro_torch.compiler.netopt.hwspace import (HW_KNOBS, HW_KNOB_NAMES,
                                                 HwCandidateSpace, hw_dict)
from repro_torch.compiler.netopt.partition import HwPartition, PartitionSpace
from repro_torch.compiler.netopt.report import NetworkReport
from repro_torch.compiler.oracle import Oracle, decode_config
from repro_torch.compiler.records import RecordLog
from repro_torch.compiler.session import Session
from repro_torch.compiler.surrogate_store import (SurrogateStore,
                                                  attach_sw_gbt, coerce_store,
                                                  space_family)
from repro_torch.compiler.task import TuningTask
from repro_torch.core import confidence_sampling as CS
from repro_torch.core.cost_model import GBTModel
from repro_torch.core.tuner import TunerConfig


@dataclasses.dataclass(frozen=True)
class NetOptConfig:
    """Budget split of one network co-optimization.

    ``total_layer_budget`` is the *upper bound* on the co-optimizer's
    per-layer measurement spend — exploration of ``n_candidates *
    layer_budget`` plus a refinement session of ``layer_budget +
    refine_budget``.  The refinement replays its winner's cached prefix
    from the per-(hw, layer) records, so the real spend is usually lower.
    The equal-budget baselines receive the full upper bound, keeping the
    comparison conservative *against* the co-optimizer.
    """

    seed_candidates: int = 3      # round-0 hw candidates (incl. the default)
    hw_rounds: int = 2            # CS-guided outer rounds after seeding
    hw_per_round: int = 2         # candidates measured per CS round
    layer_budget: int = 16        # software measurements / layer / candidate
    refine_budget: int = 32       # extra winner budget (replays warm, then
                                  # continues the software search deeper)
    tuner: TunerConfig = dataclasses.field(default_factory=TunerConfig.fast)
    hw_gbt_rounds: int = 24       # network-scope hardware surrogate
    seed: int = 0
    k_chips: int = 1              # heterogeneous pipeline stages (1..3)
    # Transfer-aware early stop: end the outer CS loop once the hardware
    # surrogate's top-``stable_top_k`` candidate ranking has been
    # unchanged for this many consecutive refits (0 = never stop early).
    stop_on_stable_ranking: int = 0
    stable_top_k: int = 3

    @property
    def n_candidates(self) -> int:
        return self.seed_candidates + self.hw_rounds * self.hw_per_round

    def total_layer_budget(self) -> int:
        return ((self.n_candidates + 1) * self.layer_budget
                + self.refine_budget)


def _coerce_partition(cand) -> HwPartition:
    """Accept a bare hw value-tuple wherever a partition is expected (the
    single-chip baselines): it is the K=1 partition."""
    if isinstance(cand, HwPartition):
        return cand
    return HwPartition((), (tuple(int(v) for v in cand),))


class _Evaluator:
    """Shared candidate-evaluation machinery for the co-optimizer and the
    network baselines (frozen / random / genetic): owns the task list, the
    partition space, the shared software GBT, the (optional) worker pool
    and the record log, evaluates one partition as a pinned multi-task
    session, and keeps the running trace the final
    :class:`NetworkReport` is built from."""

    def __init__(self, tasks: Iterable[TuningTask], cfg: NetOptConfig,
                 records: Union[None, str, RecordLog], name: str, algo: str,
                 surrogates: Union[None, str, SurrogateStore] = None,
                 trace: Optional[str] = None, obs=None, device=None,
                 workers: int = 0, timeout_s: Optional[float] = None,
                 remote=None, monitor=None, trace_sample_rate: float = 1.0):
        self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("network co-optimization needs >= 1 task")
        if remote and workers:
            raise ValueError("remote= and workers= are mutually exclusive: "
                             "one measurement transport per run")
        self.cfg = cfg
        self.device = resolve_device(device)
        # Sessions build a fresh oracle per (candidate, layer), so the
        # RecordLog is the only replay path — and the refinement pass
        # *must* replay its winner's earlier measurements or the
        # equal-budget comparison against the fixed-chip baselines would
        # silently re-pay (and re-count) them.  With no user-supplied
        # records, measurements land in an ephemeral file removed by
        # ``close()``.
        self._tmp_records_dir = None
        if records is None:
            self._tmp_records_dir = tempfile.mkdtemp(prefix="netopt-rec-")
            records = os.path.join(self._tmp_records_dir, "records.jsonl")
        self.records = (RecordLog(records) if isinstance(records, str)
                        else records)
        self.workers = int(workers)
        self.timeout_s = timeout_s
        # endpoints string/list, or an already-built RemoteExecutor the
        # caller owns — the latter is borrowed, never closed here
        self.remote = remote
        self._owns_executor = not (remote is not None
                                   and hasattr(remote, "submit"))
        self.name = name
        self.algo = algo
        self.pspace = PartitionSpace(self.tasks, cfg.k_chips)
        self.hw = self.pspace.base  # the all-tasks value unions
        # ONE software surrogate across layers and hardware candidates:
        # config features carry the hw knob values, so measurements under
        # candidate A warm-start the mapping search under candidate B.
        # With a store it also records its training rows and primes from
        # *other* networks' rows (own-network rows are excluded, so a
        # warm-from-self run replays from records).
        self.store = coerce_store(surrogates)
        self.family = space_family(self.tasks[0].space)
        self.sw_gbt, self.surrogate_stats = attach_sw_gbt(
            self.store, n_rounds=cfg.tuner.gbt_rounds, seed=cfg.seed,
            network=name, family=self.family)
        if self.surrogate_stats:
            self.surrogate_stats.update(warm_hw_rows=0, hw_rows_saved=0,
                                        warm_seeded=False)
        self.executor = None
        self.trace: List[Dict[str, object]] = []
        self.evaluated: Dict[HwPartition, Dict[str, object]] = {}
        self.cum_measurements = 0
        self.early_stop: Dict[str, object] = {}
        # span tracing: ``obs=`` borrows the caller's Tracer, ``trace=``
        # builds one and saves it to that path at close()
        self.trace_path = trace
        self.tracer = obs if obs is not None else (
            obslib.Tracer(name=name, sample_rate=trace_sample_rate)
            if trace else None)
        # live monitoring: port -> owned server, a MonitorServer instance
        # -> borrowed.  The /status source and scrape-time collector only
        # *read* evaluator/executor state, so reports stay identical with
        # monitoring on vs off.
        self.current_phase = ""
        self.monitor = None
        self._owns_monitor = False
        self._monitor_source = None
        if monitor is not None:
            from repro_torch.obs.serve import coerce_monitor
            self.monitor, self._owns_monitor = coerce_monitor(monitor)
        self.t0 = time.perf_counter()

    def obs_scope(self):
        """Ambient-tracer activation for the whole run (no-op when the run
        is untraced, so an *outer* tracer keeps collecting)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return obslib.use(self.tracer)

    def open(self) -> None:
        if self.monitor is not None and self._monitor_source is None:
            self.monitor.start()
            self._monitor_source = self.monitor.attach(
                f"netopt:{self.name}", self._live_status,
                collector=self._collect_metrics, tracer=self.tracer)
        if self.executor is not None:
            return
        if self.workers > 0:
            # one crash-isolated pool serves every (candidate, layer)
            # measurement of the whole co-optimization
            from repro_torch.compiler.executor import SubprocessExecutor
            self.executor = SubprocessExecutor(workers=self.workers,
                                               timeout_s=self.timeout_s)
        elif self.remote is not None:
            if hasattr(self.remote, "submit"):  # borrowed executor
                self.executor = self.remote
            else:
                from repro_torch.compiler.executor import RemoteExecutor
                self.executor = RemoteExecutor(self.remote,
                                               timeout_s=self.timeout_s)

    def close(self) -> None:
        # freeze the monitor's final snapshot while the executor is still
        # scrapeable; an owned server then stops with the run, a borrowed
        # one keeps serving the frozen values
        if self.monitor is not None and self._monitor_source:
            self.monitor.finalize(self._monitor_source)
        if self.executor is not None:
            if self.tracer is not None:
                self.tracer.metrics.record_executor_stats(
                    self.executor.stats())
            if self._owns_executor:
                self.executor.close()
            self.executor = None
        if self.monitor is not None and self._owns_monitor:
            self.monitor.stop()
            self.monitor = None
        if self._tmp_records_dir is not None:
            shutil.rmtree(self._tmp_records_dir, ignore_errors=True)
            self._tmp_records_dir = None
        if self.tracer is not None and self.trace_path:
            path, self.trace_path = self.trace_path, None  # save once
            self.tracer.save(path)

    # ------------------------------------------------------ live monitoring
    def best_latency_or_none(self) -> Optional[float]:
        vals = [float(e["network_latency"]) for e in self.evaluated.values()]
        return min(vals) if vals else None

    def _live_status(self) -> Dict[str, object]:
        """Copy-on-read /status section: outer-search progress + fleet
        health (the remote executor's per-endpoint detail, including
        daemon heartbeat load, rides in ``executor``)."""
        return {
            "kind": "netopt", "network": self.name, "algo": self.algo,
            "phase": self.current_phase,
            "k_chips": int(self.cfg.k_chips),
            "hw_candidates": len(self.evaluated),
            "cum_measurements": int(self.cum_measurements),
            "budget_upper_bound": int(self.cfg.total_layer_budget()
                                      * len(self.tasks)),
            "best_network_latency": self.best_latency_or_none(),
            "surrogates": dict(self.surrogate_stats),
            "early_stop": dict(self.early_stop),
            "executor": (self.executor.stats()
                         if self.executor is not None else {}),
        }

    def _collect_metrics(self, metrics) -> None:
        metrics.counter("netopt.measurements").value = \
            float(self.cum_measurements)
        metrics.counter("netopt.hw_candidates").value = \
            float(len(self.evaluated))
        best = self.best_latency_or_none()
        if best is not None:
            metrics.gauge("netopt.best_network_latency_s").set(best)
        if self.executor is not None:
            metrics.record_executor_stats(self.executor.stats())

    # ------------------------------------------------------------- evaluate
    def evaluate(self, cand, layer_budget: int, phase: str) -> float:
        """Score one partition (or bare K=1 value-tuple): pin every task
        to its stage's values, run the per-layer software agents as one
        interleaved session, return the pipeline-aware end-to-end latency.
        Re-evaluating the same candidate replays warm from the per-(hw,
        layer) records before paying for anything new."""
        self.current_phase = phase
        with obslib.current().span(f"phase:{phase}", cat="phase",
                                   budget=int(layer_budget)):
            return self._evaluate(cand, layer_budget, phase)

    def _evaluate(self, cand, layer_budget: int, phase: str) -> float:
        part = _coerce_partition(cand)
        segs = part.segments(len(self.tasks))
        tags = part.tags()
        ptasks: List[TuningTask] = []
        report_key: Dict[str, str] = {}
        for (a, b), values, tag in zip(segs, part.hw_values, tags):
            for t in self.tasks[a:b]:
                ptasks.append(t.pinned(HW_KNOBS, values, tag))
                report_key[t.name] = f"{t.name}#{tag}"
        sr = Session(ptasks, tuner=self.cfg.tuner, budget=layer_budget,
                     records=self.records, gbt=self.sw_gbt,
                     executor=self.executor, device=self.device).run()
        if part.k == 1:
            net_lat = sr.network_latency()
        else:
            per_task = {t.name: float(sr.reports[report_key[t.name]]
                                      .best_latency) for t in self.tasks}
            net_lat = self.pspace.pipeline_latency(part, per_task)
        new = sum(r.oracle_stats.get("misses", 0) for r in sr)
        self.cum_measurements += new
        # a layer whose best is the failure-penalty sentinel means a failed
        # measurement contaminated net_lat — keep it out of the persistent
        # store (deterministic analytical infeasibility still transfers)
        tainted = any(r.best_latency == Oracle.penalty_latency for r in sr)
        if self.store is not None and not tainted and self.store.add(
                "hw", self.pspace.features(part),
                -np.log(max(float(net_lat), 1e-12)), network=self.name,
                family=self.family, segs=part.k):
            self.surrogate_stats["hw_rows_saved"] = \
                int(self.surrogate_stats.get("hw_rows_saved", 0)) + 1
        prev = self.evaluated.get(part)
        if prev is None or net_lat <= float(prev["network_latency"]):
            self.evaluated[part] = {"network_latency": net_lat,
                                    "session": sr}
        best = min(float(e["network_latency"])
                   for e in self.evaluated.values())
        row = {
            "hw": (hw_dict(part.hw_values[0]) if part.k == 1
                   else [hw_dict(v) for v in part.hw_values]),
            "network_latency": float(net_lat),
            "layer_budget": int(layer_budget), "new_measurements": int(new),
            "cum_measurements": int(self.cum_measurements),
            "best_so_far": best, "phase": phase,
            "area_mm2": self.pspace.area_mm2(part),
            "trajectory": self._trajectory(part, sr, report_key, new)}
        if part.k > 1:
            row["cuts"] = list(part.cuts)
        self.trace.append(row)
        return float(net_lat)

    def _trajectory(self, part: HwPartition, sr, report_key: Dict[str, str],
                    new: int) -> List[List[float]]:
        """Within-candidate improvement points ``[paid_measurements,
        network_latency]`` from the per-task tuning histories, merged
        round-major (the session schedules tasks round-robin).  History
        counts include record-replayed hits; they are rescaled so the
        trajectory ends at this evaluation's paid (miss) count."""
        hists = {t.name: list(sr.reports[report_key[t.name]].history)
                 for t in self.tasks}
        n_rounds = max((len(h) for h in hists.values()), default=0)
        recorded_total = sum(h[-1][0] for h in hists.values() if h)
        if recorded_total <= 0:
            return []
        per_task: Dict[str, float] = {}
        prev_count = {name: 0 for name in hists}
        recorded = 0
        best_net = float("inf")
        traj: List[List[float]] = []
        for rnd in range(n_rounds):
            for t in self.tasks:
                h = hists[t.name]
                if rnd >= len(h):
                    continue
                count, task_best = int(h[rnd][0]), float(h[rnd][1])
                recorded += count - prev_count[t.name]
                prev_count[t.name] = count
                per_task[t.name] = task_best
                if len(per_task) < len(self.tasks):
                    continue  # network latency undefined until all tasks
                net = self.pspace.pipeline_latency(part, per_task)
                if net < best_net:
                    best_net = net
                    paid = int(round(recorded * new / recorded_total))
                    traj.append([paid, float(net)])
        return traj

    def best_partition(self) -> HwPartition:
        return min(self.evaluated,
                   key=lambda p: float(self.evaluated[p]["network_latency"]))

    # --------------------------------------------------------------- report
    def report(self) -> NetworkReport:
        part = self.best_partition()
        entry = self.evaluated[part]
        sr = entry["session"]
        segs = part.segments(len(self.tasks))
        tags = part.tags()
        hw_cfgs = [hw_dict(v) for v in part.hw_values]
        layers: Dict[str, Dict[str, object]] = {}
        assignment: Dict[str, int] = {}
        n_layers = 0
        for j, ((a, b), values, tag) in enumerate(
                zip(segs, part.hw_values, tags)):
            for t in self.tasks[a:b]:
                rep = sr.reports[f"{t.name}#{tag}"]
                pspace = t.space.pin(HW_KNOBS, values)
                settings = (decode_config(pspace, rep.best_config)
                            if rep.best_config else {})
                layers[t.name] = {
                    "mapping": {k: v for k, v in settings.items()
                                if k not in HW_KNOB_NAMES},
                    "hardware": dict(hw_cfgs[j]),
                    "hw_utilized": {k: settings[k] for k in HW_KNOB_NAMES
                                    if k in settings},
                    "latency": float(rep.best_latency),
                    "multiplicity": int(t.multiplicity),
                    "segment": j,
                }
                assignment[t.name] = j
                n_layers += t.multiplicity
        return NetworkReport(
            network=self.name, algo=self.algo, hw_configs=hw_cfgs,
            layers=layers,
            network_latency=float(entry["network_latency"]),
            n_layers=n_layers, hw_candidates=len(self.evaluated),
            total_measurements=self.cum_measurements,
            wall_time_s=time.perf_counter() - self.t0, trace=self.trace,
            surrogates=dict(self.surrogate_stats),
            partition={"k": part.k, "cuts": list(part.cuts),
                       "assignment": assignment},
            k_chips=part.k, early_stop=dict(self.early_stop),
            executor_stats=(self.executor.stats()
                            if self.executor is not None else {}))


class NetworkCoOptimizer:
    """The outer partition search: seed candidates (always including the
    network-default chip set, so the candidate set dominates the frozen
    baseline's), then ``hw_rounds`` rounds of GBT-scored Confidence
    Sampling over the candidate enumeration (full for K=1, a deterministic
    sampled pool for K>=2), then a refinement pass deepening the winner's
    software mappings with the leftover budget."""

    def __init__(self, tasks: Iterable[TuningTask],
                 cfg: Optional[NetOptConfig] = None,
                 records: Union[None, str, RecordLog] = None,
                 name: str = "network",
                 surrogates: Union[None, str, SurrogateStore] = None,
                 trace: Optional[str] = None, obs=None, device=None,
                 **fabric):
        self.cfg = cfg or NetOptConfig()
        self._ev = _Evaluator(tasks, self.cfg, records, name, "netopt",
                              surrogates=surrogates, trace=trace, obs=obs,
                              device=device, **fabric)
        self.pspace = self._ev.pspace
        self._pool: Optional[List[HwPartition]] = None
        self.hw_gbt = GBTModel(n_rounds=self.cfg.hw_gbt_rounds,
                               n_features=self.pspace.n_features,
                               seed=self.cfg.seed)
        # Cross-network transfer of the hardware surrogate: prime from
        # other networks' stored (hw features, fitness) rows of the same
        # dimension (14 for K=1, 15K for the segment-descriptor variant).
        self.warm_hw_rows = (self._ev.store.warm_start(
            self.hw_gbt, "hw", exclude_network=name,
            family=self._ev.family)
            if self._ev.store is not None else 0)
        if self._ev.surrogate_stats:
            self._ev.surrogate_stats["warm_hw_rows"] = int(self.warm_hw_rows)

    @property
    def hw(self) -> HwCandidateSpace:
        return self._ev.hw

    def run(self) -> NetworkReport:
        ev = self._ev
        try:
            with ev.obs_scope():
                ev.open()
                return self._run(self.cfg, ev, self.pspace,
                                 np.random.default_rng(self.cfg.seed))
        finally:
            ev.close()

    def _run(self, cfg, ev, ps, rng) -> NetworkReport:
        prev_rank: Optional[Tuple[int, ...]] = None
        stable = 0
        if self.warm_hw_rows > 0:
            # transferred hardware surrogate: spend the seed round on its
            # ranked proposals instead of uniform draws.  The two
            # guaranteed seeds stay — the network-default chip and the
            # largest geometry (VMEM frontier probe).
            cands = ps.seed_partitions(min(cfg.seed_candidates, 2), rng)
            if cfg.seed_candidates > len(cands):
                with obslib.current().span("phase:hw-select", cat="phase",
                                           rnd=-1):
                    props = self._propose(cfg.seed_candidates - len(cands),
                                          cfg.seed, exclude=cands)
                cands += props
                # only claim warm seeding when ranked proposals made it in
                ev.surrogate_stats["warm_seeded"] = bool(props)
        else:
            cands = ps.seed_partitions(cfg.seed_candidates, rng)
        for rnd in range(cfg.hw_rounds + 1):
            fresh: List[Tuple[HwPartition, float]] = []
            for part in cands:
                if part in ev.evaluated:
                    continue
                lat = ev.evaluate(part, cfg.layer_budget,
                                  "seed" if rnd == 0 else "cs")
                fresh.append((part, lat))
            if fresh:  # refit the hardware surrogate on the new points
                X = np.stack([ps.features(p) for p, _ in fresh])
                y = -np.log(np.maximum(
                    np.asarray([l for _, l in fresh]), 1e-12))
                with obslib.current().span("phase:hw-refit", cat="phase",
                                           n=len(fresh)):
                    self.hw_gbt.update(X, y)
                if cfg.stop_on_stable_ranking > 0:
                    rank = self._top_ranking(cfg.stable_top_k)
                    stable = stable + 1 if rank == prev_rank else 0
                    prev_rank = rank
                    if (stable >= cfg.stop_on_stable_ranking
                            and rnd < cfg.hw_rounds):
                        self._mark_early_stop(rnd, stable)
                        break
            if rnd == cfg.hw_rounds:
                break
            with obslib.current().span("phase:hw-select", cat="phase",
                                       rnd=rnd):
                cands = self._propose(cfg.hw_per_round, cfg.seed + rnd + 1)
        if cfg.refine_budget > 0:
            # the winner replays its layer_budget measurements from the
            # records cache, then continues the software search deeper
            ev.evaluate(ev.best_partition(),
                        cfg.layer_budget + cfg.refine_budget, "refine")
        return ev.report()

    def _mark_early_stop(self, rnd: int, stable: int) -> None:
        """Record the transfer-aware early stop: remaining CS rounds are
        skipped; ``measurements_saved`` is the per-layer budget they would
        have spent (an upper bound), summed over layers."""
        cfg, ev = self.cfg, self._ev
        skipped = (cfg.hw_rounds - rnd) * cfg.hw_per_round
        saved = skipped * cfg.layer_budget * len(ev.tasks)
        ev.early_stop = {"round": int(rnd), "stable_refits": int(stable),
                         "skipped_candidates": int(skipped),
                         "measurements_saved": int(saved)}
        ev.trace.append({"phase": "early_stop",
                         "cum_measurements": int(ev.cum_measurements),
                         **ev.early_stop})

    def _top_ranking(self, top_k: int) -> Tuple[int, ...]:
        """The surrogate's current top-k candidate ranking over a FIXED
        enumeration (full for K=1, the seed-0 pool for K>=2)."""
        ps = self.pspace
        if ps.k == 1:
            feats = np.stack([ps.base.features(ps.base.values(ix))
                              for ix in ps.base.all_index_configs()])
        else:
            feats = np.stack([ps.features(p) for p in self._scored_pool()])
        scores = np.asarray(self.hw_gbt.predict(feats), np.float64)
        order = np.lexsort((np.arange(len(scores)), -scores))
        return tuple(int(i) for i in order[:max(top_k, 0)])

    def _scored_pool(self) -> List[HwPartition]:
        if self._pool is None:
            self._pool = self.pspace.candidate_pool(self.cfg.seed)
        return self._pool

    def _propose(self, n: int, seed: int,
                 exclude: Sequence[HwPartition] = ()) -> List[HwPartition]:
        """Confidence Sampling over the candidate enumeration, scored by
        the network-scope GBT; already-evaluated (and ``exclude``d)
        candidates are skipped and the batch is topped up by predicted
        score."""
        ev, ps = self._ev, self.pspace
        if ps.k == 1:
            hw = ps.base
            all_idx = hw.all_index_configs()
            feats = np.stack([hw.features(hw.values(ix)) for ix in all_idx])
            scores = np.asarray(self.hw_gbt.predict(feats), np.float64)
            picked = CS.confidence_sampling(
                all_idx, scores, n + len(ev.evaluated) + len(exclude),
                hw.n_choices, seed=seed)
            out: List[HwPartition] = []
            seen = ({p.hw_values[0] for p in ev.evaluated}
                    | {p.hw_values[0] for p in exclude})
            for ix in picked:
                v = hw.values(ix)
                if v not in seen:
                    seen.add(v)
                    out.append(HwPartition((), (v,)))
                if len(out) >= n:
                    return out
            for i in np.argsort(-scores):  # top-up: best predicted
                v = hw.values(all_idx[i])
                if v not in seen:
                    seen.add(v)
                    out.append(HwPartition((), (v,)))
                if len(out) >= n:
                    break
            return out
        pool = self._scored_pool()
        enc = np.stack([ps.encode(p) for p in pool])
        feats = np.stack([ps.features(p) for p in pool])
        scores = np.asarray(self.hw_gbt.predict(feats), np.float64)
        picked = CS.confidence_sampling(
            enc, scores, n + len(ev.evaluated) + len(exclude),
            ps.n_choices, seed=seed)
        seen_p = set(ev.evaluated) | set(exclude)
        out = []
        for vec in picked:
            p = ps.decode(vec)
            if p not in seen_p:
                seen_p.add(p)
                out.append(p)
            if len(out) >= n:
                return out
        for i in np.argsort(-scores):
            p = pool[int(i)]
            if p not in seen_p:
                seen_p.add(p)
                out.append(p)
            if len(out) >= n:
                break
        return out


def netopt_tune(tasks: Iterable[TuningTask],
                cfg: Optional[NetOptConfig] = None,
                **kw) -> NetworkReport:
    """One-call co-optimization: ``NetworkCoOptimizer(tasks, cfg, ...).run()``."""
    return NetworkCoOptimizer(tasks, cfg, **kw).run()


def network_hw_frozen_tune(tasks: Iterable[TuningTask],
                           cfg: Optional[NetOptConfig] = None,
                           records: Union[None, str, RecordLog] = None,
                           name: str = "network",
                           surrogates: Union[None, str,
                                             SurrogateStore] = None,
                           trace: Optional[str] = None, obs=None,
                           device=None, **fabric) -> NetworkReport:
    """Network-scope hw-frozen baseline: the single network-default chip,
    with the co-optimizer's *entire* per-layer budget spent on software
    mapping under it (equal-measurement-budget comparison)."""
    cfg = cfg or NetOptConfig()
    ev = _Evaluator(tasks, cfg, records, name, "hw_frozen",
                    surrogates=surrogates, trace=trace, obs=obs,
                    device=device, **fabric)
    try:
        with ev.obs_scope():
            ev.open()
            ev.evaluate(ev.hw.default_values(ev.tasks),
                        cfg.total_layer_budget(), "frozen")
            return ev.report()
    finally:
        ev.close()


def network_random_hw_tune(tasks: Iterable[TuningTask],
                           cfg: Optional[NetOptConfig] = None,
                           n_candidates: int = 4,
                           records: Union[None, str, RecordLog] = None,
                           name: str = "network",
                           surrogates: Union[None, str,
                                             SurrogateStore] = None,
                           trace: Optional[str] = None, obs=None,
                           device=None, **fabric) -> NetworkReport:
    """Network-scope random-hardware baseline: uniform candidates, budget
    split evenly — ablates the GBT + CS outer search."""
    cfg = cfg or NetOptConfig()
    ev = _Evaluator(tasks, cfg, records, name, "random_hw",
                    surrogates=surrogates, trace=trace, obs=obs,
                    device=device, **fabric)
    rng = np.random.default_rng(cfg.seed)
    n_candidates = max(min(n_candidates, ev.hw.size), 1)
    per_layer = max(cfg.total_layer_budget() // n_candidates, 1)
    try:
        with ev.obs_scope():
            ev.open()
            attempts = 0
            while len(ev.evaluated) < n_candidates and attempts < 64:
                attempts += 1
                v = ev.hw.values([rng.integers(0, len(c))
                                  for c in ev.hw.choices])
                if _coerce_partition(v) in ev.evaluated:
                    continue
                ev.evaluate(v, per_layer, "random")
            return ev.report()
    finally:
        ev.close()
