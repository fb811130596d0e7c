"""Deterministic stub measure functions for executor tests and benches.

``make_stub`` is the :class:`~repro_torch.compiler.executor.base.WorkerSpec`
factory used by the port's executor tests and the card's fabric phase
(``chip_smoke.py``), a copy of the reference's: a cheap, torch-free oracle whose
latency is a pure function of the settings dict (CRC-based, so parent and
spawned workers agree), with opt-in delay / raise / hang behaviors keyed
on settings subsets to exercise every failure path.
"""
from __future__ import annotations

import json
import time
import zlib
from typing import Callable, Dict, Optional


def _matches(settings: Dict[str, object],
             cond: Optional[Dict[str, object]]) -> bool:
    return bool(cond) and all(settings.get(k) == v for k, v in cond.items())


def stub_latency(settings: Dict[str, object]) -> float:
    """Deterministic pseudo-latency in (0, 1], identical across processes
    (``hash()`` is salted per process; CRC32 of the sorted JSON is not)."""
    crc = zlib.crc32(json.dumps(settings, sort_keys=True,
                                default=str).encode())
    return (crc % 10_000 + 1) / 10_000.0


def make_stub(delay_s: float = 0.0,
              fail_when: Optional[Dict[str, object]] = None,
              hang_when: Optional[Dict[str, object]] = None,
              exit_when: Optional[Dict[str, object]] = None,
              hang_s: float = 3600.0
              ) -> Callable[[Dict[str, object]], float]:
    """Build ``fn(settings) -> latency``.

    ``delay_s``   sleep per measurement (models compile latency);
    ``fail_when`` settings subset that raises (feasibility failure);
    ``hang_when`` settings subset that sleeps ``hang_s`` (timeout path);
    ``exit_when`` settings subset that hard-kills the process via
                  ``os._exit`` (worker-crash path).
    """

    def fn(settings: Dict[str, object]) -> float:
        if _matches(settings, exit_when):
            import os
            os._exit(17)
        if _matches(settings, hang_when):
            time.sleep(hang_s)
        if _matches(settings, fail_when):
            raise RuntimeError("stub measurement failed")
        if delay_s:
            time.sleep(delay_s)
        return stub_latency(settings)

    return fn
