"""``repro_torch.compiler.executor`` — the measurement-execution protocol
and its in-process executor (the pool and the remote fabric come with a
later slice of the port)."""
from repro_torch.compiler.executor.base import (Executor, MeasureHandle,
                                                MeasureResult, SerialExecutor)

__all__ = ["Executor", "MeasureHandle", "MeasureResult", "SerialExecutor"]
