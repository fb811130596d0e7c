"""Self times of the program's spans, and a tracer that shows them to the
profiler.

The tuner emits spans into the ambient ``repro_torch.obs`` tracer
(``session``, ``seed-draw``, ``mappo-update``, ``measure``,
``surrogate-refit``); the harness installs one with ``obs.use`` around the
window.  A span's self time is its duration less the part of it that its
direct children cover.  :func:`profiled_tracer` makes a tracer whose every
span is also a ``torch.profiler.record_function`` range, so a profiler
trace can say which span the host was in.
"""
from __future__ import annotations

from typing import Dict, List


def self_seconds(spans: List[Dict[str, object]], name: str) -> float:
    """Summed self time of the spans called ``name``."""
    total = 0.0
    for s in spans:
        if s["name"] != name:
            continue
        t0, t1 = float(s["t"]), float(s["t"]) + float(s["dur"])
        kids = sum(float(c["dur"]) for c in spans
                   if c["tid"] == s["tid"] and c["depth"] == s["depth"] + 1
                   and float(c["t"]) >= t0
                   and float(c["t"]) + float(c["dur"]) <= t1)
        total += float(s["dur"]) - kids
    return total


def profiled_tracer():
    """A ``repro_torch.obs.Tracer`` whose spans are profiler ranges too."""
    import torch
    from repro_torch import obs

    class _Both:
        __slots__ = ("_span", "_range")

        def __init__(self, span, name):
            self._span = span
            self._range = torch.profiler.record_function(name)

        def __enter__(self):
            self._range.__enter__()
            self._span.__enter__()
            return self

        def __exit__(self, *exc):
            self._span.__exit__(*exc)
            self._range.__exit__(*exc)
            return False

    class ProfiledTracer(obs.Tracer):
        def span(self, name, cat="", tid=None, **args):
            return _Both(super().span(name, cat, tid, **args), name)

    return ProfiledTracer(name="dcoc_bench")


def per_session(run, name: str):
    """Self seconds of the window's ``name`` spans over its sessions;
    None where the run recorded no such span."""
    spans, sessions = run.obs.get("spans"), run.obs.get("sessions")
    if not spans or not any(s["name"] == name for s in spans):
        return None
    return self_seconds(spans, name) / len(sessions)
