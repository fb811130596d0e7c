"""Persistent GBT training rows — cross-network surrogate transfer.

A tuning run learns two surrogates: the network-scope **hardware** GBT
(``[log2 hw values ++ aggregate workload descriptor]`` rows, see
``repro_torch.compiler.netopt.hwspace``) and the per-config **software** GBT
(``[log2 knob values ++ cell descriptor]`` rows, see
``DesignSpace.feature_vector``).  Both feature layouts carry the workload
half explicitly, which is what makes the rows *transferable*: a surrogate
warm-started from another network's rows can tell that network's
measurements apart from the new one's and still generalize across them.

:class:`SurrogateStore` persists those rows to JSONL so the tuner becomes
an **accumulating system** instead of a per-run tool:

* ``netopt --save-surrogates s.jsonl`` appends every GBT training row of
  the run (keyed by kind, feature dimension, and network name);
* ``netopt --warm-from s.jsonl`` on a *different* network primes both
  GBTs from the stored rows before the first measurement — the outer
  hardware search then seeds from surrogate-ranked candidates instead of
  uniform draws, and MAPPO explores against an informed reward from
  episode one.

This is **transfer**, not replay: :class:`~repro_torch.compiler.records.
RecordLog` replays exact (task, config) measurements of the *same*
network, while the store moves surrogate knowledge across *different*
networks.  Rows whose ``network`` matches the warm-starting run are
excluded (they re-enter through the run's own records), so warming a run
from its own store is exactly the cold run — record replay still yields
zero new measurements.

Durability piggybacks on :class:`RecordLog` (atomic line appends,
torn-tail repair).  Every row carries the feature-schema version; a store
written by an incompatible version is rejected loudly
(:class:`SurrogateSchemaError`) instead of silently mis-training.  Rows
are the reference package's (same schema, kinds, features and targets),
so a store written by either package warm-starts the other.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

import numpy as np

from repro_torch.compiler.oracle import Oracle
from repro_torch.compiler.records import RecordLog
from repro_torch.core.cost_model import GBTModel

# Bump when the meaning of a row changes (feature normalization, target
# transform, kinds).  Rows additionally carry their feature dimension, so
# differently-shaped spaces coexist in one store and loading filters to
# the consumer's layout.  v2 adds the segment-descriptor variant of hw
# rows (``segs`` = pipeline stages K; K>=2 rows carry K*15-dim features)
# — v1 rows are valid v2 rows with ``segs`` = 1, so v1 stores still load.
SCHEMA = "repro-surrogate/2"
COMPATIBLE_SCHEMAS = ("repro-surrogate/1", SCHEMA)
KINDS = ("sw", "hw")   # software (per-config) / hardware (per-candidate)

# The fitness value of an executor failure-penalty row
# (-log(Oracle.penalty_latency) in the float32 the GBT trains on) —
# recognized so transient worker failures never become persistent
# cross-network training data.
_PENALTY_Y = np.float32(-np.log(Oracle.penalty_latency))


class SurrogateSchemaError(ValueError):
    """A stored row does not match this code's feature schema."""


def space_family(space) -> str:
    """Coarse feature-compatibility family of a design space.  Conv and
    GEMM spaces share the 7-knob core geometry and its feature semantics
    (``"core"``); pod-level :class:`~repro_torch.core.shard_space.ShardSpace`
    cells reuse the same 18-dim layout but every slot means something
    else (model_axis, moment dtype, ... / cell descriptor), so their rows
    must never warm a core GBT (``"pod"``) — equal dimension is not
    equal meaning."""
    from repro_torch.core.shard_space import ShardSpace
    return "pod" if isinstance(space, ShardSpace) else "core"


def _row_key(kind: str, x: Iterable[float], y: float) -> Tuple:
    return (kind, tuple(float(v) for v in x), float(y))


class SurrogateStore:
    """Append-only JSONL store of (features, target) GBT training rows.

    One row per line::

        {"schema": "repro-surrogate/1", "kind": "hw", "dim": 14,
         "network": "vgg-11", "x": [...], "y": 7.81}

    ``y`` is the fitness target the GBTs train on (``-log latency``).
    Exact duplicate rows (same kind, features, target — e.g. a warm
    resume re-feeding replayed measurements) are deduplicated on append.
    """

    def __init__(self, path: str, readonly: bool = False):
        self._log = RecordLog(path)
        self.readonly = readonly
        self._rows: Optional[List[Dict]] = None
        self._keys: Set[Tuple] = set()

    @property
    def path(self) -> str:
        return self._log.path

    def exists(self) -> bool:
        return self._log.exists()

    # ------------------------------------------------------------------ load
    def _load(self) -> List[Dict]:
        if self._rows is None:
            rows = []
            for row in self._log.load():
                schema = row.get("schema")
                if schema not in COMPATIBLE_SCHEMAS:
                    raise SurrogateSchemaError(
                        f"{self.path}: row schema {schema!r} != {SCHEMA!r} "
                        "— the store was written by an incompatible "
                        "version; regenerate it (rows are cheap: re-run "
                        "with --save-surrogates)")
                if row.get("kind") not in KINDS:
                    raise SurrogateSchemaError(
                        f"{self.path}: unknown row kind {row.get('kind')!r}")
                key = _row_key(row["kind"], row["x"], row["y"])
                if key in self._keys:
                    continue
                self._keys.add(key)
                rows.append(row)
            self._rows = rows
        return self._rows

    # ----------------------------------------------------------------- write
    def add(self, kind: str, x, y: float, network: str = "",
            task: str = "", family: str = "core", segs: int = 1) -> bool:
        """Append one training row; returns False when skipped (readonly
        store or exact duplicate).  ``family`` (:func:`space_family`)
        marks feature-semantic compatibility — loads filter on it.
        ``segs`` is the segment-descriptor variant marker for hw rows
        (pipeline stages K of the candidate the row scores; 1 = the v1
        single-chip layout)."""
        return self.add_many(kind, [x], [y], network=network, task=task,
                             family=family, segs=segs) == 1

    def add_many(self, kind: str, X, y, network: str = "",
                 task: str = "", family: str = "core",
                 segs: int = 1) -> int:
        """Append a batch of training rows in one write (one fd + one
        ``os.write`` for the whole batch — this sits on the tuning hot
        path, once per GBT refit); returns how many rows were actually
        added (readonly stores and exact duplicates are skipped)."""
        if self.readonly:
            return 0
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        rows = self._load()
        new_rows: List[Dict] = []
        for xi, yi in zip(X, y):
            xi = [float(v) for v in np.asarray(xi, np.float32).reshape(-1)]
            yi = float(np.float32(yi))
            key = _row_key(kind, xi, yi)
            if key in self._keys:
                continue
            self._keys.add(key)
            new_rows.append({"schema": SCHEMA, "kind": kind, "dim": len(xi),
                             "family": family, "network": network,
                             "task": task, "segs": int(segs),
                             "x": xi, "y": yi})
        rows.extend(new_rows)
        self._log.append_many(new_rows)
        return len(new_rows)

    def merge_from(self, other: Union[str, "SurrogateStore"]) -> int:
        """Copy another store's rows into this one (schema-checked,
        deduplicated, one batched write); returns the number of rows
        actually added."""
        if self.readonly:
            return 0
        if isinstance(other, str):
            other = SurrogateStore(other, readonly=True)
        rows = self._load()
        new_rows: List[Dict] = []
        for row in other._load():
            key = _row_key(row["kind"], row["x"], row["y"])
            if key in self._keys:
                continue
            self._keys.add(key)
            new_rows.append({"schema": SCHEMA, "kind": row["kind"],
                             "dim": len(row["x"]),
                             "family": row.get("family", "core"),
                             "network": row.get("network", ""),
                             "task": row.get("task", ""),
                             "segs": int(row.get("segs", 1)),
                             "x": row["x"], "y": row["y"]})
        rows.extend(new_rows)
        self._log.append_many(new_rows)
        return len(new_rows)

    # ----------------------------------------------------------------- query
    def rows(self, kind: str, dim: int,
             exclude_network: Optional[str] = None,
             family: str = "core") -> Tuple[np.ndarray, np.ndarray]:
        """(X, y) of every stored row matching ``kind`` and ``family``
        whose feature dimension is ``dim``.  Rows from
        ``exclude_network`` are dropped — transfer is cross-network by
        definition; a run's own rows re-enter through its measurement
        records."""
        sel = [r for r in self._load()
               if r["kind"] == kind and r["dim"] == dim
               and r.get("family", "core") == family
               and (exclude_network is None
                    or r.get("network") != exclude_network)]
        if not sel:
            return (np.zeros((0, dim), np.float32), np.zeros(0, np.float32))
        X = np.asarray([r["x"] for r in sel], np.float32)
        y = np.asarray([r["y"] for r in sel], np.float32)
        return X, y

    def networks(self, kind: Optional[str] = None) -> Tuple[str, ...]:
        return tuple(sorted({r.get("network", "") for r in self._load()
                             if kind is None or r["kind"] == kind}))

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in KINDS}
        for r in self._load():
            out[r["kind"]] += 1
        return out

    # ------------------------------------------------------------ warm start
    def warm_start(self, gbt: GBTModel, kind: str,
                   exclude_network: Optional[str] = None,
                   family: str = "core") -> int:
        """Prime ``gbt`` with every stored row matching its feature width
        and space family; returns the number of rows transferred (0
        leaves the model cold).  A :class:`RecordingGBT` is primed
        through ``prime`` so transferred rows are not re-saved to its own
        store."""
        X, y = self.rows(kind, gbt.n_features, exclude_network, family)
        if len(X) == 0:
            return 0
        prime = getattr(gbt, "prime", gbt.update)
        prime(X, y)
        return len(X)

    # -------------------------------------------------------------- compact
    def compact(self, keep_best: int = 32) -> Dict[str, int]:
        """Rewrite the store keeping, per (kind, network, family, dim,
        segs) group, only the *Pareto-informative* rows (each row that
        improved on every earlier fitness in its group — the search's
        improvement frontier, what a warm start needs to rank the
        promising region) plus the ``keep_best`` highest-fitness rows.
        Bounds store growth to ``O(groups * keep_best + frontier)``
        regardless of how many runs accumulated — the pre-work for
        generator-scale corpora.  Atomic rewrite (same guarantee as the
        appends); returns ``{"kept": ..., "dropped": ...}``."""
        if self.readonly:
            raise ValueError("cannot compact a readonly store")
        rows = self._load()
        groups: Dict[Tuple, List[Dict]] = {}
        for r in rows:  # insertion order == append order within a group
            key = (r["kind"], r.get("network", ""),
                   r.get("family", "core"), r["dim"],
                   int(r.get("segs", 1)))
            groups.setdefault(key, []).append(r)
        keep_ids = set()
        for grp in groups.values():
            best = -np.inf
            for r in grp:  # improvement frontier, in append order
                if r["y"] > best:
                    best = r["y"]
                    keep_ids.add(id(r))
            for r in sorted(grp, key=lambda r: -r["y"])[:keep_best]:
                keep_ids.add(id(r))
        kept = [r for r in rows if id(r) in keep_ids]
        dropped = len(rows) - len(kept)
        if dropped:
            self._log.rewrite(kept)
            self._rows = kept
            self._keys = {_row_key(r["kind"], r["x"], r["y"]) for r in kept}
        return {"kept": len(kept), "dropped": dropped}


@dataclasses.dataclass
class RecordingGBT(GBTModel):
    """A :class:`GBTModel` that tees every ``update`` batch into a
    :class:`SurrogateStore` — the seam that captures software-surrogate
    training rows without touching the tuning loops that call
    ``gbt.update``.  ``prime`` updates without recording (warm starts:
    transferred rows must not be re-saved as this run's)."""

    store: Optional[SurrogateStore] = None
    store_kind: str = "sw"
    network: str = ""
    family: str = "core"

    def update(self, X, y) -> None:
        super().update(X, y)
        if self.store is not None and not self.store.readonly:
            Xr = np.asarray(X, np.float32).reshape(-1, self.n_features)
            yr = np.asarray(y, np.float32).reshape(-1)
            # executor failure-penalty rows (a worker timed out/crashed on
            # this config) are transient environment noise: this GBT still
            # trains on them (the in-run search must avoid the config),
            # but persisting them would poison every later network's warm
            # start permanently.  Deterministic infeasibility (the
            # analytical oracle's 1e12 sentinel) is real, transferable
            # knowledge and passes through.
            keep = yr != _PENALTY_Y
            self.store.add_many(self.store_kind, Xr[keep], yr[keep],
                                network=self.network, family=self.family)

    def prime(self, X, y) -> None:
        GBTModel.update(self, X, y)


def coerce_store(surrogates: Union[None, str, SurrogateStore]
                 ) -> Optional[SurrogateStore]:
    """``surrogates=`` arguments accept a path or a store; a path is an
    accumulating (read + write) store."""
    if surrogates is None or isinstance(surrogates, SurrogateStore):
        return surrogates
    return SurrogateStore(surrogates)


def attach_sw_gbt(store: Optional[SurrogateStore], n_rounds: int, seed: int,
                  network: str, family: str
                  ) -> Tuple[RecordingGBT, Dict[str, object]]:
    """The one way a run wires its software GBT to a store (shared by
    ``Session`` and netopt's evaluator): build the recording GBT, prime
    it from every compatible foreign row, and return it with the stats
    dict reports carry.  Stats are empty without a store."""
    gbt = RecordingGBT(n_rounds=n_rounds, seed=seed, store=store,
                       store_kind="sw", network=network, family=family)
    if store is None:
        return gbt, {}
    warm = store.warm_start(gbt, "sw", exclude_network=network,
                            family=family)
    return gbt, {"store": store.path, "readonly": store.readonly,
                 "warm_sw_rows": int(warm)}


# ----------------------------------------------------------------- CLI glue

def add_surrogate_args(ap) -> None:
    """``--warm-from`` / ``--save-surrogates`` on a tuning argparse CLI."""
    ap.add_argument("--warm-from", default=None, metavar="SURR.jsonl",
                    help="surrogate store to warm-start the GBT cost "
                         "models from (cross-network transfer; rows from "
                         "the same network are excluded)")
    ap.add_argument("--save-surrogates", default=None, metavar="SURR.jsonl",
                    help="append this run's GBT training rows here "
                         "(accumulating store; may equal --warm-from)")
    ap.add_argument("--compact", action="store_true",
                    help="after the run, compact --save-surrogates down "
                         "to its Pareto-informative + per-(network, "
                         "family) best rows (bounds store growth)")


def store_from_args(args) -> Optional[SurrogateStore]:
    """Build the store the run should use from the CLI flags:

    * only ``--warm-from``: read-only (prime, never write);
    * only ``--save-surrogates``: accumulating store at that path (a
      pre-existing file also warm-starts — that is the accumulation);
    * both: rows from ``--warm-from`` are merged into the save store
      first, so the output file is self-contained.
    """
    warm, save = args.warm_from, args.save_surrogates
    if getattr(args, "compact", False) and not save:
        raise SystemExit("--compact needs --save-surrogates (it rewrites "
                         "the store this run appends to)")
    same = bool(warm and save
                and os.path.realpath(warm) == os.path.realpath(save))
    if warm and not same and not os.path.exists(warm):
        # a typo'd path must not silently degrade into a cold run (when
        # both flags name ONE file — accumulate-in-place — a first run
        # legitimately starts with no store yet)
        raise SystemExit(f"--warm-from {warm}: no such surrogate store")
    if save:
        store = SurrogateStore(save)
        if warm and not same:
            store.merge_from(warm)
        return store
    if warm:
        return SurrogateStore(warm, readonly=True)
    return None
