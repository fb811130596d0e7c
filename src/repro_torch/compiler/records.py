"""JSONL measurement records — the persistence layer of a tuning session.

One row per *new* oracle measurement:

    {"task": "...", "config": [idx, ...], "latency": 1.2e-4,
     "features": [...18 floats...], ...extras...}

Extras carry decoded ``settings`` (shard-space oracles), compact compile
``result`` summaries, or an ``error`` string for failed measurements.  A
session pointed at an existing record file resumes *warm*: every oracle
primes its memo cache from the rows matching its task, so re-running the
same session replays from cache instead of re-paying oracle cost, and a
larger budget continues the search where the file left off.

Durability contract (what parallel measurement leans on): every append is
one ``os.write`` of a whole ``json.dumps(row) + "\n"`` line to an
``O_APPEND`` descriptor — atomic on POSIX, so rows from a run killed
mid-write can corrupt at most the trailing line, and ``load()`` drops a
corrupt *trailing* line so a killed run always warm-resumes.  Corruption
anywhere else is a real error and still raises.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.obs import log


class RecordLog:
    """Append-only JSONL file of oracle measurements (shared across tasks)."""

    def __init__(self, path: str):
        self.path = path
        self._tail_checked = False  # torn-tail repair runs once per instance

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def load(self, task: Optional[str] = None) -> List[Dict]:
        """All persisted rows (optionally filtered to one task).

        A corrupt trailing line — the signature of a run killed mid-append
        — is dropped with a warning instead of failing the resume; corrupt
        rows anywhere else raise.
        """
        if not self.exists():
            return []
        with open(self.path) as f:
            lines = [ln.strip() for ln in f.read().splitlines()]
        idx_nonempty = [i for i, ln in enumerate(lines) if ln]
        rows: List[Dict] = []
        for i in idx_nonempty:
            try:
                row = json.loads(lines[i])
            except ValueError:
                if i == idx_nonempty[-1]:
                    log.warn(f"RecordLog: dropping corrupt trailing line "
                             f"{i + 1} of {self.path} (killed mid-append?)")
                    break
                raise ValueError(
                    f"{self.path}:{i + 1}: corrupt record mid-file") from None
            if task is None or row.get("task") == task:
                rows.append(row)
        return rows

    def append(self, row: Dict) -> None:
        """Atomic line append: a single ``os.write`` of the whole line to an
        ``O_APPEND`` fd, so concurrent appenders and kills never interleave
        or tear a row (beyond the trailing line ``load`` tolerates).  A
        torn tail left by a killed run is truncated first — otherwise the
        new row would merge into it and turn recoverable trailing
        corruption into a mid-file error on the next resume."""
        self.append_many([row])

    def append_many(self, rows: List[Dict]) -> None:
        """Append a batch of rows with ONE ``os.write`` of all the lines —
        same whole-line atomicity contract as :meth:`append`, without
        paying an open/write/close round-trip per row (the surrogate
        store appends every GBT refit batch through this)."""
        if not rows:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if not self._tail_checked:
            # only a *previous* run's kill can leave a torn tail — our own
            # appends are whole-line writes — so one check per instance
            self._truncate_torn_tail()
            self._tail_checked = True
        data = "".join(json.dumps(row) + "\n" for row in rows).encode()
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)

    def rewrite(self, rows: List[Dict]) -> None:
        """Atomically replace the whole file with ``rows`` (tmp file in
        the same directory + ``os.replace``, so a reader or a kill never
        sees a partial state) — the seam store compaction rewrites
        through.  The append-only contract still holds for *measurement*
        records; rewrite exists for derived stores that prune."""
        import tempfile
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".rewrite-", suffix=".jsonl",
                                   dir=d)
        try:
            os.write(fd, "".join(json.dumps(row) + "\n"
                                 for row in rows).encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)
        self._tail_checked = True

    def _truncate_torn_tail(self) -> None:
        """Drop a trailing partial line (no terminating newline) — the same
        row ``load()`` already ignores, removed for good before we append
        behind it.  O(1) when the file is healthy (checks the last byte)."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            data = f.read()
            f.truncate(data.rfind(b"\n") + 1)
