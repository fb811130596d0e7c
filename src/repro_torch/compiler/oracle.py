"""Measurement oracles — the single seam every tuner measures through.

The protocol is ``measure(configs) -> (latencies, features)`` over int
choice-index configurations.  The base class owns the cross-cutting
concerns: memoization (keyed on the config tuple), JSONL record
persistence (via :class:`repro_torch.compiler.records.RecordLog`, rows
interchangeable with the reference's), hit/miss/dedup accounting.

Measurement is split-phase underneath: ``measure_async(configs)`` returns
a :class:`PendingBatch` whose ``get()`` yields ``(latencies, features)``.
The analytical oracle resolves the batch eagerly at submit time; the seam
is where executor-backed oracles plug in (a later slice of the port).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.compiler.records import RecordLog
from repro_torch.core.design_space import DesignSpace


def decode_config(space: DesignSpace, config) -> Dict[str, object]:
    """Choice indices -> human-readable knob settings for ``space``."""
    return {name: int(space.choices[k][int(config[k])])
            for k, name in enumerate(space.knob_names)}


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
                lat, feats, extras = self._inflight.collect()
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
    for cache misses; dedup, cache fill, JSONL rows and stats are shared.
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
        """Start measuring ``configs``; the default computes eagerly
        in-process via ``_measure_batch``."""
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
    def n_cached(self) -> int:
        return len(self._cache)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "dedup": self.dedup, "failures": self.failures,
                "cached": self.n_cached}


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
