"""Leveled structured logging for the tuning stack's diagnostics.

``REPRO_LOG=debug|info|warn`` selects the threshold (default ``warn``);
the env var is read at call time so tests and long-lived daemons can
flip verbosity without re-imports.  Output is plain flushed stdout lines
— byte-identical to the ad-hoc ``print(...)`` calls this replaces when
no structured fields are attached, so default output is unchanged.
Structured fields render as a trailing ``[k=v ...]`` block.

The mapping from the old prints: diagnostics that always showed
(corrupt-record drops) are ``warn``; diagnostics gated on a ``verbose``
flag stay gated (the caller picks ``warn`` vs ``info``/``debug`` by its
flag), with ``REPRO_LOG=debug`` additionally surfacing the quiet path.
"""
from __future__ import annotations

import os

_LEVELS = {"debug": 10, "info": 20, "warn": 30}
_DEFAULT = "warn"


def threshold() -> int:
    """Current numeric threshold from ``REPRO_LOG`` (default warn)."""
    name = os.environ.get("REPRO_LOG", _DEFAULT).strip().lower()
    return _LEVELS.get(name, _LEVELS[_DEFAULT])


def enabled(level: str) -> bool:
    return _LEVELS[level] >= threshold()


def log(level: str, msg: str, **fields) -> None:
    if _LEVELS[level] < threshold():
        return
    if fields:
        tail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        msg = f"{msg} [{tail}]"
    print(msg, flush=True)


def debug(msg: str, **fields) -> None:
    log("debug", msg, **fields)


def info(msg: str, **fields) -> None:
    log("info", msg, **fields)


def warn(msg: str, **fields) -> None:
    log("warn", msg, **fields)
