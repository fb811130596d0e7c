"""Trace persistence: Chrome-trace/Perfetto JSON and raw JSONL (a copy of
the reference's ``repro/obs/export.py``; files interchangeable with its).

The Chrome JSON object format (``{"traceEvents": [...]}``) loads
directly into ``chrome://tracing`` and https://ui.perfetto.dev: complete
spans are ``ph: "X"`` with microsecond ``ts``/``dur``, instant events
``ph: "i"``.  Timestamps are wall-clock microseconds (tracer epoch +
monotonic offset) so traces merged from several hosts line up.  The
metrics registry snapshot rides along under ``otherData`` — extra
top-level keys are explicitly allowed by the format.

``save_trace(tracer, "run.jsonl")`` instead writes one raw event dict
per line (with a ``wall_s`` absolute-start field), the
append-friendly form ``tools/trace_summary.py`` also reads.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List


def chrome_trace(tracer) -> Dict[str, object]:
    """Render a :class:`~repro_torch.obs.trace.Tracer` to the Chrome trace
    object format."""
    pid = os.getpid()
    out: List[Dict[str, object]] = []
    for ev in tracer.events():
        row: Dict[str, object] = {
            "name": ev["name"],
            "cat": ev["cat"] or "default",
            "ph": ev["ph"],
            "ts": (tracer.epoch + ev["t"]) * 1e6,
            "pid": pid,
            "tid": ev["tid"],
        }
        if ev["ph"] == "X":
            row["dur"] = ev["dur"] * 1e6
        if ev["ph"] == "i":
            row["s"] = "t"  # instant scope: thread
        if "args" in ev:
            row["args"] = ev["args"]
        out.append(row)
    other: Dict[str, object] = {
        "tracer": tracer.name,
        "metrics": tracer.metrics.snapshot(),
    }
    sampling = getattr(tracer, "sampling_stats", lambda: {})()
    if sampling:
        other["sampling"] = sampling
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def save_trace(tracer, path: str) -> None:
    """Write ``tracer`` to ``path``: raw JSONL when the suffix is
    ``.jsonl``, Chrome-trace JSON otherwise."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # default=str: a stray non-JSON span arg must never lose the whole
    # trace at the end of a long run
    if str(path).endswith(".jsonl"):
        with open(path, "w") as f:
            for ev in tracer.events():
                row = dict(ev)
                row["wall_s"] = tracer.epoch + row.pop("t")
                f.write(json.dumps(row, sort_keys=True, default=str) + "\n")
            # sampled tracer: a trailing metadata row carries the exact
            # kept/dropped bookkeeping (ph "M" — readers that only look
            # at "X"/"i" rows skip it harmlessly)
            sampling = getattr(tracer, "sampling_stats", lambda: {})()
            if sampling:
                f.write(json.dumps(
                    {"ph": "M", "name": "sampling", "args": sampling,
                     "wall_s": 0.0}, sort_keys=True, default=str) + "\n")
        return
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, indent=1, default=str)
        f.write("\n")
