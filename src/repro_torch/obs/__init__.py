"""``repro_torch.obs`` — the tuning stack's tracing, metrics, logging and
live monitoring.

A copy of the reference's stdlib-only ``repro.obs`` (the port imports
nothing of ``repro``): the ambient span :class:`~repro_torch.obs.trace.Tracer`
that the ARCO loop, the oracles and all three executors emit into (a
shared no-op by default; span sampling for million-measurement runs), the
counters/gauges/histograms registry it carries, the ``REPRO_LOG``-leveled
logger, Chrome-trace/JSONL export, and the live
:class:`~repro_torch.obs.serve.MonitorServer` (``/metrics``, ``/status``,
``/trace``).  Stdlib only: spawned measurement workers and worker daemons
import it and must never pay a torch import.  Trace files, Prometheus text
and ``/status`` documents are interchangeable with the reference's.
"""
from repro_torch.obs.metrics import Metrics, NoopMetrics
from repro_torch.obs.serve import (MonitorServer, active_servers,
                                   prometheus_text)
from repro_torch.obs.trace import NOOP, NoopTracer, Tracer, current, use

__all__ = [
    "Metrics",
    "MonitorServer",
    "NOOP",
    "NoopMetrics",
    "NoopTracer",
    "Tracer",
    "active_servers",
    "current",
    "prometheus_text",
    "use",
]
