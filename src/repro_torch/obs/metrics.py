"""Counters / gauges / histograms behind one thread-safe registry (a copy
of the reference's ``repro/obs/metrics.py``).

The registry unifies the per-executor ``stats()`` shapes: every executor
already answers the same eight keys (``kind``, ``workers_alive``,
``respawns``, ``queued``, ``running``, ``max_inflight``, ``jobs``,
``failures``), and :meth:`Metrics.record_executor_stats` maps them onto
typed instruments — monotone totals become counters, point-in-time
occupancy becomes gauges — so a saved trace carries the terminal
executor state next to its spans (``otherData.metrics`` in the Chrome
export).

Like the tracer, a :class:`NoopMetrics` singleton makes the disabled
path allocation-free: instrument lookups return shared do-nothing
objects.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Mapping


class Counter:
    """Monotonically increasing total (jobs completed, failures, ...).

    ``inc`` takes a per-instrument lock: ``x += n`` is not atomic at the
    bytecode level, and the monitor server scrapes counters that many
    executor threads increment concurrently."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written point-in-time value (queue depth, busy slots, ...).
    A single-field overwrite is atomic under the GIL — no lock needed."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming count/sum/min/max plus power-of-two exponential buckets
    — enough for mean latencies *and* coarse quantiles without holding
    every observation.

    Bucket ``e`` counts values in ``(2**(e-1), 2**e]``; non-positive
    values land in a single underflow bucket.  Quantile estimates return
    the upper bound of the bucket holding the target rank, clamped to
    the observed ``[min, max]`` — deterministic, and exact whenever a
    bucket bound coincides with an observation."""

    __slots__ = ("count", "sum", "min", "max", "_buckets", "_lock")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._buckets: Dict[int, int] = {}  # exponent -> count
        self._lock = threading.Lock()

    @staticmethod
    def _exponent(v: float) -> int:
        if v <= 0.0:
            return -(10 ** 9)  # underflow bucket, sorts before everything
        return max(math.ceil(math.log2(v)), -64)

    def observe(self, v: float) -> None:
        v = float(v)
        e = self._exponent(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._buckets[e] = self._buckets.get(e, 0) + 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate of the observed stream."""
        with self._lock:
            if not self.count:
                return float("nan")
            rank = max(math.ceil(q * self.count), 1)
            seen = 0
            for e in sorted(self._buckets):
                seen += self._buckets[e]
                if seen >= rank:
                    bound = 0.0 if e <= -64 else 2.0 ** e
                    return min(max(bound, self.min), self.max)
            return self.max

    def snapshot(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.sum / self.count,
                "p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99)}


class Metrics:
    """Thread-safe name -> instrument registry.

    Instruments are created on first use (``counter("jobs").inc()``);
    updates take the registry lock only on creation — counters and
    histograms carry their own fine-grained locks (their updates are
    read-modify-write), gauges are single atomic stores.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, cls())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def record_executor_stats(self, stats: Mapping[str, object],
                              prefix: str = "executor") -> None:
        """Map the uniform ``Executor.stats()`` keys onto instruments.

        Totals (``jobs``, ``failures``, ``respawns``) land as counters
        *set to* the executor's own running total (executors already
        accumulate; re-recording overwrites rather than double-counts),
        occupancy (``workers_alive``, ``queued``, ``running``,
        ``max_inflight``) as gauges.
        """
        kind = stats.get("kind", "?")
        for key in ("jobs", "failures", "respawns"):
            if key in stats:
                c = self.counter(f"{prefix}.{kind}.{key}")
                c.value = float(stats[key])  # overwrite: source is a total
        for key in ("workers_alive", "queued", "running", "max_inflight"):
            if key in stats:
                self.gauge(f"{prefix}.{kind}.{key}").set(float(stats[key]))

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._histograms.items()},
            }


class _NoopInstrument:
    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snapshot(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0}


_NOOP_INSTRUMENT = _NoopInstrument()


class NoopMetrics:
    """Allocation-free stand-in used by the disabled tracer."""

    __slots__ = ()

    def counter(self, name: str) -> _NoopInstrument:
        return _NOOP_INSTRUMENT

    def gauge(self, name: str) -> _NoopInstrument:
        return _NOOP_INSTRUMENT

    def histogram(self, name: str) -> _NoopInstrument:
        return _NOOP_INSTRUMENT

    def record_executor_stats(self, stats: Mapping[str, object],
                              prefix: str = "executor") -> None:
        pass

    def snapshot(self) -> Dict[str, object]:
        return {}
