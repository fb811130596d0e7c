"""Nested-span tracer with an ambient (process-global) current tracer
(a copy of the reference's ``repro/obs/trace.py``, stdlib only).

Spans are timed with ``time.monotonic`` and anchored to wall clock via a
single ``epoch`` offset captured at tracer creation, so traces from
different processes/hosts merge onto one timeline: a remote daemon ships
``(wall_start_s, dur_s)`` pairs and :meth:`Tracer.add_span` re-anchors
them against the local epoch.

The ambient tracer (:func:`current` / :func:`use`) is how instrumented
library code finds the active tracer without threading it through every
call signature: ``Session.run`` / ``NetworkCoOptimizer.run`` activate
their tracer around the whole run, and everything underneath — the ARCO
loop, oracles, executors — emits into ``current()``.  The default is the
shared :data:`NOOP` singleton whose ``span()`` hands back one reusable
no-op context manager, so uninstrumented runs pay a dict-free attribute
lookup per span site and nothing else.  ``use()`` is re-entrant; a ``Session`` run *inside* an active
netopt trace inherits the outer tracer because a session without its own
``trace=``/``obs=`` never overrides the ambient one.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Metrics, NoopMetrics

# Categories eligible for probabilistic sampling: the per-measurement
# firehose.  Structural spans (phases, session/mappo/gbt steps) are
# always kept — they are few and carry the wall-clock attribution.
SAMPLED_CATS = frozenset({"measure", "dispatch"})


class _SpanHandle:
    """Context manager for one open span; re-used per call, not pooled —
    span entry/exit only happens on instrumented (non-noop) runs."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 tid: Optional[str], args: Optional[dict]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args

    def __enter__(self) -> "_SpanHandle":
        self._tracer._stack().append(self._name)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.monotonic() - self._t0
        stack = self._tracer._stack()
        stack.pop()
        self._tracer._record(self._name, self._cat, self._t0, dur,
                             self._tid, self._args, depth=len(stack))
        return False


class Tracer:
    """Thread-safe collector of duration spans and instant events.

    Internal event rows are plain dicts with monotonic-seconds
    timestamps; :mod:`repro_torch.obs.export` converts them to Chrome-trace
    microseconds.  ``metrics`` is a full :class:`Metrics` registry that
    rides along into the export's ``otherData``.
    """

    def __init__(self, name: str = "repro", sample_rate: float = 1.0,
                 sample_seed: int = 0) -> None:
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self.name = name
        self.enabled = True
        # wall-clock seconds at monotonic zero: wall = epoch + monotonic
        self.epoch = time.time() - time.monotonic()
        self.metrics = Metrics()
        # Span sampling for million-measurement runs: spans in
        # SAMPLED_CATS are kept with probability ``sample_rate`` (own
        # RNG — the tuner's seeded RNG streams must not shift with the
        # sampling decision); dropped spans still accumulate exact
        # (count, total-duration) bookkeeping per category so
        # trace_summary coverage math stays honest.
        self.sample_rate = float(sample_rate)
        self._sample_rng = random.Random(sample_seed)
        self._kept: Dict[str, int] = {}
        self._dropped: Dict[str, List[float]] = {}  # cat -> [count, dur_s]
        self._lock = threading.Lock()
        self._events: List[Dict[str, object]] = []
        self._local = threading.local()

    # -- span / event emission ------------------------------------------

    def span(self, name: str, cat: str = "", tid: Optional[str] = None,
             **args) -> _SpanHandle:
        """``with tracer.span("measure", cat="measure", task=t): ...``"""
        return _SpanHandle(self, name, cat, tid, args or None)

    def event(self, name: str, cat: str = "", tid: Optional[str] = None,
              **args) -> None:
        """Zero-duration instant event (Chrome ``ph: "i"``)."""
        ev: Dict[str, object] = {
            "name": name, "cat": cat, "ph": "i", "t": time.monotonic(),
            "tid": tid or threading.current_thread().name,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_span(self, name: str, cat: str = "", *, wall_start_s: float,
                 dur_s: float, tid: str = "remote",
                 args: Optional[dict] = None) -> None:
        """Ingest an externally timed span (e.g. shipped from a remote
        daemon) by its wall-clock start, re-anchored to this tracer's
        timeline."""
        self._record(name, cat, wall_start_s - self.epoch, dur_s, tid,
                     args, depth=0)

    def add_span_mono(self, name: str, cat: str = "", *,
                      start_mono_s: float, dur_s: float, tid: str = "",
                      args: Optional[dict] = None) -> None:
        """Record an already-finished span timed locally with
        ``time.monotonic()`` (executor event loops learn a job's extent
        only when its result arrives)."""
        self._record(name, cat, start_mono_s, dur_s, tid or None, args,
                     depth=0)

    def _record(self, name: str, cat: str, t_mono: float, dur_s: float,
                tid: Optional[str], args: Optional[dict],
                depth: int) -> None:
        ev: Dict[str, object] = {
            "name": name, "cat": cat, "ph": "X", "t": t_mono,
            "dur": dur_s,
            "tid": tid or threading.current_thread().name,
            "depth": depth,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if self.sample_rate < 1.0 and cat in SAMPLED_CATS:
                if self._sample_rng.random() >= self.sample_rate:
                    acc = self._dropped.get(cat)
                    if acc is None:
                        acc = self._dropped[cat] = [0, 0.0]
                    acc[0] += 1
                    acc[1] += dur_s
                    return
                self._kept[cat] = self._kept.get(cat, 0) + 1
            self._events.append(ev)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- inspection / persistence ---------------------------------------

    def events(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._events)

    def sampling_stats(self) -> Dict[str, object]:
        """Per-category kept/dropped bookkeeping — ``{}`` at rate 1.0 (no
        sampling, nothing to account for).  ``dropped_dur_s`` is the
        *exact* summed duration of dropped spans, so category totals can
        be reconstructed exactly rather than estimated from the rate."""
        if self.sample_rate >= 1.0:
            return {}
        with self._lock:
            cats: Dict[str, Dict[str, float]] = {}
            for cat in sorted(set(self._kept) | set(self._dropped)):
                d = self._dropped.get(cat, (0, 0.0))
                cats[cat] = {"kept": int(self._kept.get(cat, 0)),
                             "dropped": int(d[0]),
                             "dropped_dur_s": float(d[1])}
            return {"sample_rate": self.sample_rate, "cats": cats}

    def recent_spans(self, limit: int = 256) -> List[Dict[str, object]]:
        """Tail of the most recent complete spans, wall-clock anchored —
        the copy-on-read snapshot ``/trace`` serves.  The lock is held
        only for the tail slice; dict conversion happens outside it."""
        with self._lock:
            tail = self._events[-max(int(limit), 0) * 4:] if limit else []
        out: List[Dict[str, object]] = []
        for ev in tail:
            if ev["ph"] != "X":
                continue
            row: Dict[str, object] = {
                "name": ev["name"], "cat": ev["cat"],
                "tid": ev["tid"], "depth": ev["depth"],
                "wall_s": self.epoch + float(ev["t"]),
                "dur_s": float(ev["dur"]),
            }
            if "args" in ev:
                row["args"] = ev["args"]
            out.append(row)
        return out[-max(int(limit), 0):]

    def spans(self) -> List[Dict[str, object]]:
        return [e for e in self.events() if e["ph"] == "X"]

    def phase_times(self) -> Dict[str, float]:
        """Summed seconds per named top-level phase span (``cat ==
        "phase"``) — the ``phase_times`` block bench artifacts embed."""
        out: Dict[str, float] = {}
        for e in self.spans():
            if e.get("cat") == "phase":
                out[str(e["name"])] = (out.get(str(e["name"]), 0.0)
                                       + float(e["dur"]))
        return out

    def save(self, path: str) -> None:
        """Write the trace: Chrome-trace JSON (Perfetto-loadable), or
        raw JSONL when ``path`` ends in ``.jsonl``."""
        from repro_torch.obs.export import save_trace
        save_trace(self, path)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()
_NOOP_METRICS = NoopMetrics()


class NoopTracer:
    """Disabled tracer: every call is a constant-return no-op."""

    __slots__ = ()
    enabled = False
    metrics = _NOOP_METRICS

    def span(self, name: str, cat: str = "", tid: Optional[str] = None,
             **args) -> _NoopSpan:
        return _NOOP_SPAN

    def event(self, name: str, cat: str = "", tid: Optional[str] = None,
              **args) -> None:
        pass

    def add_span(self, name: str, cat: str = "", *, wall_start_s: float,
                 dur_s: float, tid: str = "remote",
                 args: Optional[dict] = None) -> None:
        pass

    def add_span_mono(self, name: str, cat: str = "", *,
                      start_mono_s: float, dur_s: float, tid: str = "",
                      args: Optional[dict] = None) -> None:
        pass

    def phase_times(self) -> Dict[str, float]:
        return {}

    def sampling_stats(self) -> Dict[str, object]:
        return {}

    def recent_spans(self, limit: int = 256) -> List[Dict[str, object]]:
        return []

    def save(self, path: str) -> None:
        pass


NOOP = NoopTracer()

_current: "Tracer | NoopTracer" = NOOP


def current() -> "Tracer | NoopTracer":
    """The ambient tracer instrumented code emits into (default: NOOP)."""
    return _current


class _Use:
    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer) -> None:
        self._tracer = tracer if tracer is not None else NOOP

    def __enter__(self):
        global _current
        self._prev = _current
        _current = self._tracer
        return self._tracer

    def __exit__(self, *exc) -> bool:
        global _current
        _current = self._prev
        return False


def use(tracer) -> _Use:
    """``with obs.use(tracer): ...`` — install ``tracer`` as the ambient
    tracer for the dynamic extent of the block (re-entrant; restores the
    previous one on exit).  ``use(None)`` installs the no-op tracer."""
    return _Use(tracer)
