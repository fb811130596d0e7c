"""``repro_torch.obs`` — the tuning stack's tracing, metrics and logging.

A copy of the stdlib-only parts of ``repro.obs`` (the port imports
nothing of ``repro``): the ambient span :class:`~repro_torch.obs.trace.Tracer`
that the ARCO loop and the oracles emit into (a shared no-op by default),
the counters/gauges/histograms registry it carries, the
``REPRO_LOG``-leveled logger, and Chrome-trace/JSONL export.  Trace files
are interchangeable with the reference's.
"""
from repro_torch.obs.metrics import Metrics, NoopMetrics
from repro_torch.obs.trace import NOOP, NoopTracer, Tracer, current, use

__all__ = [
    "Metrics",
    "NOOP",
    "NoopMetrics",
    "NoopTracer",
    "Tracer",
    "current",
    "use",
]
