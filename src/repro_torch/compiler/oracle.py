"""Measurement oracles — the single seam every tuner measures through.

The protocol is ``measure(configs) -> (latencies, features)`` over int
choice-index configurations.  The base class owns the cross-cutting
concerns: memoization (keyed on the config tuple), JSONL record
persistence (via :class:`repro_torch.compiler.records.RecordLog`, rows
interchangeable with the reference's), hit/miss/dedup/failure accounting
and the failed-measurement penalty.

Measurement is split-phase underneath: ``measure_async(configs)`` returns
a :class:`PendingBatch` whose ``get()`` yields ``(latencies, features)``.
The analytical oracle resolves the batch eagerly at submit time; a
:class:`SettingsOracle` on a :class:`~repro_torch.compiler.executor.
SubprocessExecutor` (or a remote fleet, or a server's idle slots) keeps
the batch genuinely in flight, letting a session overlap GBT refits and
MAPPO updates with measurements.  Results always land back in this
parent-process oracle, so memo/records/resume semantics are identical no
matter who executed the measurement.

Three concrete oracles:

* :class:`AnalyticalOracle` — the batched analytical TPU v5e model
  (``DesignSpace.measure``) on ``device`` (default ``cuda``).
* :class:`SettingsOracle` — one python measure function per decoded knob
  *settings* dict, run through an executor, with the failure penalty.
* :class:`CompileOracle` — the pod-level compile oracle: one dry-run
  estimate + roofline of an LM cell per measurement
  (``launch.autotune.compile_and_analyze``: the port's step counted on the
  ``meta`` device where the reference compiles it); ``workers=N`` fans its
  measurements across a crash-isolated subprocess pool.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.compiler.executor import (Executor, MeasureResult,
                                           SerialExecutor, WorkerSpec)
from repro_torch.compiler.records import RecordLog
from repro_torch.core.design_space import DesignSpace
from repro_torch.obs import log


def decode_config(space: DesignSpace, config) -> Dict[str, object]:
    """Choice indices -> human-readable knob settings for ``space``."""
    vals = [space.choices[k][int(config[k])] for k in range(space.n_knobs)]
    from repro_torch.core.shard_space import (ShardSpace,
                                              knob_values_to_settings)
    if isinstance(space, ShardSpace):
        return knob_values_to_settings(vals)
    return {name: int(v) for name, v in zip(space.knob_names, vals)}


class _EagerBatch:
    """In-flight facade over results that were computed at submit time."""

    def __init__(self, results):
        self._results = results  # (lat, feats, extras)

    def ready(self) -> bool:
        return True

    def collect(self):
        return self._results


class PendingBatch:
    """One ``measure_async`` call: cache misses possibly still in flight.

    ``ready()`` is non-blocking; ``get()`` blocks until every miss has a
    result, fills the memo cache / JSONL records / counters exactly once,
    and returns ``(latencies, features)`` aligned with the submitted
    configs (hits and in-batch duplicates included).
    """

    def __init__(self, oracle: "Oracle", keys: List[Tuple[int, ...]],
                 n_hits: int, n_dedup: int, miss_idx: List[int], inflight):
        self._oracle = oracle
        self._keys = keys
        self._n_hits = n_hits
        self._n_dedup = n_dedup
        self._miss_idx = miss_idx
        self._inflight = inflight
        self._collected = False

    def ready(self) -> bool:
        return (self._collected or self._inflight is None
                or self._inflight.ready())

    def get(self) -> Tuple[np.ndarray, np.ndarray]:
        o = self._oracle
        if not self._collected:
            if self._inflight is not None:
                with obs.current().span("measure-wait", cat="executor-wait",
                                        task=o.task,
                                        n=len(self._miss_idx)):
                    lat, feats, extras = self._inflight.collect()
                with obs.current().span("records", cat="records",
                                        task=o.task,
                                        n=len(self._miss_idx)):
                    for j, i in enumerate(self._miss_idx):
                        o._remember(self._keys[i], float(lat[j]),
                                    np.asarray(feats[j], np.float32),
                                    extras[j] if extras else None)
            o.misses += len(self._miss_idx)
            o.hits += self._n_hits
            o.dedup += self._n_dedup
            self._collected = True  # only after the cache is fully filled
        lat = np.asarray([o._cache[k][0] for k in self._keys], np.float64)
        feats = np.stack([o._cache[k][1] for k in self._keys])
        return lat, feats


class Oracle:
    """Memoizing, record-persisting measurement oracle (protocol base).

    Subclasses implement ``_measure_batch(configs) -> (lat, feats, extras)``
    for cache misses (or override ``_submit_batch`` for asynchronous
    execution); dedup, cache fill, JSONL rows and stats are shared.
    """

    penalty_latency = 1e6  # recorded for measurements that fail

    def __init__(self, space: DesignSpace, task: str = "",
                 records: Optional[RecordLog] = None):
        self.space = space
        self.task = task or "task"
        self.records = records
        self.hits = 0
        self.misses = 0
        self.dedup = 0     # in-batch duplicates (measured once per batch)
        self.failures = 0
        self._cache: Dict[Tuple[int, ...], Tuple[float, np.ndarray]] = {}
        if records is not None:
            for row in records.load(task=self.task):
                key = tuple(int(x) for x in row["config"])
                self._cache[key] = (float(row["latency"]),
                                    np.asarray(row["features"], np.float32))

    # ------------------------------------------------------------- protocol
    def measure(self, configs) -> Tuple[np.ndarray, np.ndarray]:
        """(n, n_knobs) choice indices -> (latencies (n,), features (n, F))."""
        return self.measure_async(configs).get()

    def measure_async(self, configs) -> PendingBatch:
        """Submit a batch.  A config already in the cache is a *hit*; a
        config repeated within the batch is a *dedup* (measured once); the
        rest are misses."""
        configs = np.asarray(configs).reshape(-1, self.space.n_knobs)
        keys = [tuple(int(x) for x in c) for c in configs]
        miss_idx: List[int] = []
        pending = set()
        n_hits = n_dedup = 0
        for i, k in enumerate(keys):
            if k in self._cache:
                n_hits += 1
            elif k in pending:
                n_dedup += 1
            else:
                miss_idx.append(i)
                pending.add(k)
        inflight = self._submit_batch(configs[miss_idx]) if miss_idx else None
        return PendingBatch(self, keys, n_hits, n_dedup, miss_idx, inflight)

    def _submit_batch(self, configs: np.ndarray):
        """Start measuring ``configs``; returns an in-flight object with
        ``ready()`` / ``collect() -> (lat, feats, extras)``.  The default
        computes eagerly in-process via ``_measure_batch``."""
        with obs.current().span("measure", cat="measure", task=self.task,
                                n=len(configs)):
            return _EagerBatch(self._measure_batch(configs))

    def _measure_batch(self, configs: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, Optional[List]]:
        raise NotImplementedError

    def close(self) -> None:
        """Release any execution resources this oracle owns."""

    # ------------------------------------------------------------ internals
    def _remember(self, key: Tuple[int, ...], lat: float, feats: np.ndarray,
                  extra: Optional[Dict]) -> None:
        self._cache[key] = (lat, feats)
        if self.records is not None:
            row = {"task": self.task, "config": list(key), "latency": lat,
                   "features": [float(x) for x in feats]}
            if extra:
                row.update(extra)
            self.records.append(row)

    @property
    def seen(self):
        """Keys of every memoized configuration (incl. resumed records)."""
        return self._cache.keys()

    @property
    def n_cached(self) -> int:
        return len(self._cache)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "dedup": self.dedup, "failures": self.failures,
                "cached": self.n_cached}

    def features(self, configs) -> np.ndarray:
        """GBT features of ``configs``, computed on the host (the
        per-settings oracles measure there too)."""
        c = torch.as_tensor(np.asarray(configs), dtype=torch.long)
        return self.space.feature_vector(c).numpy().astype(np.float32)


class AnalyticalOracle(Oracle):
    """Batched analytical simulator oracle over ``space.measure``, run on
    ``device`` (default ``cuda``).  Cheap and vectorized — always measured
    in-process."""

    def __init__(self, space: DesignSpace, task: str = "",
                 records: Optional[RecordLog] = None, device=None):
        self.device = resolve_device(device)
        super().__init__(space, task=task, records=records)

    def _measure_batch(self, configs):
        c = torch.as_tensor(np.asarray(configs), dtype=torch.long,
                            device=self.device)
        lat = self.space.measure(c).cpu().numpy().astype(np.float64)
        feats = self.space.feature_vector(c).cpu().numpy().astype(np.float32)
        return lat, feats, None


class _ExecutorBatch:
    """Handles for one batch of per-settings jobs on an executor."""

    def __init__(self, oracle: "SettingsOracle", handles, feats):
        self._oracle = oracle
        self._handles = handles
        self._feats = feats

    def ready(self) -> bool:
        self._oracle.executor.poll()
        return all(h.done() for h in self._handles)

    def collect(self):
        o = self._oracle
        o.executor.drain(self._handles)
        lats = np.empty(len(self._handles), np.float64)
        extras: List[Dict] = []
        for i, h in enumerate(self._handles):
            lats[i], extra = o._settle(h.settings, h.result())
            extras.append(extra)
        return lats, self._feats, extras


class SettingsOracle(Oracle):
    """Per-config oracle over decoded knob *settings* with failure penalty.

    ``fn(settings)`` returns either a latency float or a result dict with a
    ``step_penalized_s`` entry.  A failed measurement — the fn raised, the
    worker died, or the job timed out — records the hinge
    ``penalty_latency`` plus the error string: an infeasible configuration
    must never win the search, but the surrogate still learns from it.

    Execution goes through an :class:`~repro_torch.compiler.executor.
    Executor`; the default :class:`SerialExecutor` runs each measurement
    in-process at submit time, while a ``SubprocessExecutor`` fans the
    batch across workers — ``measure`` still blocks for the whole batch,
    but ``measure_async`` lets a session overlap other work.  Features
    are computed on the host.  ``close()`` tears the executor down iff
    this oracle built it (or ``own_executor=True`` says so); a borrowed
    executor (a session's shared pool) outlives it.
    """

    def __init__(self, space: DesignSpace,
                 fn: Optional[Callable[[Dict], object]] = None,
                 task: str = "", records: Optional[RecordLog] = None,
                 verbose: bool = False,
                 executor: Optional[Executor] = None,
                 own_executor: Optional[bool] = None,
                 worker_spec: Optional[WorkerSpec] = None):
        if fn is None and executor is None:
            raise ValueError("SettingsOracle needs fn= and/or executor=")
        self.fn = fn
        self.verbose = verbose
        self.executor = executor or SerialExecutor(fn=fn)
        # jobs carry this spec so a *shared* executor (one pool serving a
        # whole multi-task session) measures with this oracle's factory
        self.worker_spec = worker_spec
        self._own_executor = (executor is None if own_executor is None
                              else own_executor)
        super().__init__(space, task=task, records=records)

    _RESULT_KEYS = ("step_s", "compile_s", "hbm_residency_gib", "feasible",
                    "dominant")

    def _submit_batch(self, configs):
        feats = self.features(configs) if len(configs) else \
            np.zeros((0, 0), np.float32)
        handles = [self.executor.submit(self.task,
                                        decode_config(self.space, cfg),
                                        spec=self.worker_spec)
                   for cfg in configs]
        return _ExecutorBatch(self, handles, feats)

    def _settle(self, settings: Dict[str, object],
                res: MeasureResult) -> Tuple[float, Dict]:
        """Map one executor result to (latency, JSONL extras)."""
        extra: Dict[str, object] = {"settings": settings}
        error = res.error
        lat = None
        if res.ok:
            out = res.value
            try:  # a malformed result is a failure, not a session crash
                if isinstance(out, dict):
                    lat = float(out["step_penalized_s"])
                    extra["result"] = {k: out[k] for k in self._RESULT_KEYS
                                       if k in out}
                else:
                    lat = float(out)
            except Exception as e:
                error = f"{type(e).__name__}: {e}"
        if lat is None:  # infeasible / crashed / timed out / malformed
            self.failures += 1
            lat = self.penalty_latency
            extra["error"] = error[:300]
            # verbose oracles surface every failure; quiet ones still log
            # it at debug so REPRO_LOG=debug exposes the penalty rows
            log.log("warn" if self.verbose else "debug",
                    f"  measure {settings}: FAILED {extra['error'][:140]}")
        return lat, extra

    def close(self) -> None:
        if self._own_executor:
            self.executor.close()


def default_devices() -> int:
    """The pod's placeholder device count: ``REPRO_DRYRUN_DEVICES``, else
    256 (the reference reads jax's device count, pinned the same way)."""
    return int(os.environ.get("REPRO_DRYRUN_DEVICES", "256"))


def _compile_measure_factory(arch: str, shape: str, verbose: bool = False,
                             n_devices: Optional[int] = None
                             ) -> Callable[[Dict[str, object]], Dict]:
    """WorkerSpec factory for :class:`CompileOracle` workers: the measure
    function over one cell, imported inside the worker."""
    from repro_torch.launch.autotune import compile_and_analyze

    def fn(settings: Dict[str, object]) -> Dict[str, object]:
        return compile_and_analyze(arch, shape, settings, verbose=verbose,
                                   n_devices=n_devices)

    return fn


def _pinned_xla_flags(n_devices: int) -> str:
    """Current XLA_FLAGS with the placeholder device count forced to
    ``n_devices``: the wire's ``device_count_pin`` routes on it, the
    contract shared with the reference's worker daemons."""
    kept = [f for f in os.environ.get("XLA_FLAGS", "").split()
            if not f.startswith("--xla_force_host_platform_device_count")]
    kept.append(f"--xla_force_host_platform_device_count={n_devices}")
    return " ".join(kept)


class CompileOracle(SettingsOracle):
    """Pod-level compile oracle: one dry-run estimate + roofline of one LM
    cell per measurement, over ``n_devices`` placeholder devices (default
    :func:`default_devices`).

    ``workers=0`` (default) measures in-process, one at a time.
    ``workers=N`` fans measurements across N spawned worker processes,
    each building its measure function from this oracle's ``WorkerSpec``
    (``_compile_measure_factory`` with the cell and the device count), with
    ``timeout_s`` per-measurement timeouts and crash isolation.  A
    multi-task session passes one shared ``executor=`` instead (jobs carry
    this oracle's spec; the pool then belongs to the session).  The spec's
    env pins the device count in ``XLA_FLAGS``, as the reference's does, so
    remote daemons route these jobs as they route the reference's."""

    def __init__(self, arch: str, shape: str, n_devices: Optional[int] = None,
                 task: str = "", records: Optional[RecordLog] = None,
                 verbose: bool = True,
                 space: Optional[DesignSpace] = None,
                 workers: int = 0, timeout_s: Optional[float] = None,
                 executor: Optional[Executor] = None):
        n_devices = n_devices or default_devices()
        if space is None:
            from repro_torch.core.shard_space import ShardSpace
            space = ShardSpace.for_cell(arch, shape, measure_fn=None,
                                        n_devices=n_devices)
        self.arch, self.shape = arch, shape
        self.n_devices = n_devices
        self.workers = int(workers)
        self.timeout_s = timeout_s

        spec = WorkerSpec(
            factory="repro_torch.compiler.oracle:_compile_measure_factory",
            kwargs={"arch": arch, "shape": shape, "verbose": verbose,
                    "n_devices": n_devices},
            env={"XLA_FLAGS": _pinned_xla_flags(n_devices)})
        own = executor is None
        if executor is None and self.workers > 0:
            from repro_torch.compiler.executor import SubprocessExecutor
            executor = SubprocessExecutor(spec, workers=self.workers,
                                          timeout_s=timeout_s)

        # same wiring in-process and in workers: one factory, two homes
        fn = _compile_measure_factory(arch, shape, verbose=verbose,
                                      n_devices=n_devices)
        super().__init__(space, fn, task=task or f"{arch}/{shape}",
                         records=records, verbose=verbose,
                         executor=executor, own_executor=own,
                         worker_spec=spec)
