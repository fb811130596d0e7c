"""``repro_torch.compiler`` — tuning sessions on the PyTorch port.

A :class:`Session` runs ARCO or a baseline over :class:`TuningTask`\\ s
measured through memoizing :class:`Oracle`\\ s, sharing a GBT cost model
across tasks, persisting / resuming from JSONL records and transferring
surrogate rows between networks (:class:`SurrogateStore`);
``repro_torch.compiler.netopt`` co-optimizes one chip (or a K-chip
pipeline) for a whole network from the workload zoo (:func:`get_network`).
``python -m repro_torch.compiler.cli --help`` is the command line.

Exports resolve lazily: ``repro_torch.core.tuner`` imports the
oracle/report submodules directly, so an eager ``from .session import
Session`` here would close an import cycle.
"""
import importlib

_EXPORTS = {
    "Oracle": "repro_torch.compiler.oracle",
    "AnalyticalOracle": "repro_torch.compiler.oracle",
    "decode_config": "repro_torch.compiler.oracle",
    "Executor": "repro_torch.compiler.executor",
    "SerialExecutor": "repro_torch.compiler.executor",
    "MeasureResult": "repro_torch.compiler.executor",
    "RecordLog": "repro_torch.compiler.records",
    "TuneReport": "repro_torch.compiler.report",
    "Tracker": "repro_torch.compiler.report",
    "TuningTask": "repro_torch.compiler.task",
    "Session": "repro_torch.compiler.session",
    "SessionReport": "repro_torch.compiler.session",
    "SurrogateStore": "repro_torch.compiler.surrogate_store",
    "SurrogateSchemaError": "repro_torch.compiler.surrogate_store",
    "RecordingGBT": "repro_torch.compiler.surrogate_store",
    "NetworkTask": "repro_torch.compiler.zoo",
    "get_network": "repro_torch.compiler.zoo",
    "network_names": "repro_torch.compiler.zoo",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'repro_torch.compiler' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
