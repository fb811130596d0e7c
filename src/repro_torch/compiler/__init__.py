"""``repro_torch.compiler`` — tuning sessions on the PyTorch port.

A :class:`Session` runs ARCO over :class:`TuningTask`\\ s measured through
memoizing :class:`Oracle`\\ s, sharing a GBT cost model across tasks and
persisting / resuming from JSONL records.  ``python -m
repro_torch.compiler.cli --help`` is the command line.

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
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'repro_torch.compiler' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
