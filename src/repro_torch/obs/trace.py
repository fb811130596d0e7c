"""Nested-span tracer with an ambient (process-global) current tracer.

A trimmed copy of the reference's ``repro/obs/trace.py`` (duration spans
only: no span sampling, no instant events, no remote-span ingestion — the
port has no measurement fabric yet).  Spans
are timed with ``time.monotonic`` and anchored to wall clock via a single
``epoch`` offset captured at tracer creation, so saved traces line up with
the reference's and load in ``tools/trace_summary.py``.

The ambient tracer (:func:`current` / :func:`use`) is how instrumented
library code finds the active tracer without threading it through every
call signature: ``Session.run`` activates its tracer around the whole run,
and everything underneath — the ARCO loop, the oracles — emits into
``current()``.  The default is the shared :data:`NOOP` singleton whose
``span()`` hands back one reusable no-op context manager, so untraced runs
pay an attribute lookup per span site and nothing else.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Metrics, NoopMetrics


class _SpanHandle:
    """Context manager for one open span."""

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
    """Thread-safe collector of duration spans.

    Event rows are plain dicts with monotonic-seconds timestamps;
    :mod:`repro_torch.obs.export` converts them to Chrome-trace
    microseconds.  ``metrics`` rides along into the export's ``otherData``.
    """

    def __init__(self, name: str = "repro") -> None:
        self.name = name
        # wall-clock seconds at monotonic zero: wall = epoch + monotonic
        self.epoch = time.time() - time.monotonic()
        self.metrics = Metrics()
        self._lock = threading.Lock()
        self._events: List[Dict[str, object]] = []
        self._local = threading.local()

    def span(self, name: str, cat: str = "", tid: Optional[str] = None,
             **args) -> _SpanHandle:
        """``with tracer.span("measure", cat="measure", task=t): ...``"""
        return _SpanHandle(self, name, cat, tid, args or None)

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
            self._events.append(ev)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def events(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._events)

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
    metrics = _NOOP_METRICS

    def span(self, name: str, cat: str = "", tid: Optional[str] = None,
             **args) -> _NoopSpan:
        return _NOOP_SPAN

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
