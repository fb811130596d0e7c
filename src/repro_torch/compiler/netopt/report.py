"""Typed, JSON-serializable result of a network-scope co-optimization.

A :class:`NetworkReport` is to ``repro_torch.compiler.netopt`` what
:class:`~repro_torch.compiler.report.TuneReport` is to one task: the chosen
hardware partition (K accelerator configs + contiguous pipeline cuts —
K=1 is the v1 single shared chip), every layer's software mapping under
its assigned chip, pipeline-aware end-to-end latency, the
hardware-candidate trace with its best-so-far progress curve, and the
multi-objective latency-vs-silicon Pareto frontier over the evaluated
candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class NetworkReport:
    """Result of co-optimizing one network on a K-chip partition."""

    network: str
    algo: str            # "netopt" | "hw_frozen" | "random_hw" | "genetic"
    # one geometry (knob values) per pipeline stage, in stage order; K=1
    # reports additionally expose the single entry as ``hw_config``
    hw_configs: List[Dict[str, int]]
    # per unique task: {"mapping": software knob settings,
    #                   "hardware": the stage's hw config,
    #                   "hw_utilized": per-layer clamped tile actually
    #                                  exercised (<= hardware, small layers
    #                                  underutilize the shared dimension),
    #                   "latency": best per-layer latency (s),
    #                   "multiplicity": layers sharing this workload,
    #                   "segment": pipeline stage index}
    layers: Dict[str, Dict[str, object]]
    network_latency: float           # pipeline-aware end-to-end (s); K=1:
                                     # sum(latency * multiplicity)
    n_layers: int                    # sum of multiplicities
    hw_candidates: int               # distinct partitions evaluated
    total_measurements: int          # new oracle measurements paid (misses)
    wall_time_s: float
    # one row per candidate evaluation, in evaluation order:
    # {"hw": {...} (K=1) | [{...}, ...] (K>=2), "network_latency": float,
    #  "new_measurements": int, "cum_measurements": int, "best_so_far":
    #  float, "phase": "seed" | "cs" | "refine" | "frozen" | "random" |
    #  "genetic", "area_mm2": float, "trajectory": [[paid, latency], ...],
    #  "cuts": [...] (K>=2 only)} — plus one marker row {"phase":
    #  "early_stop", "measurements_saved": int, ...} when the
    #  stable-ranking stop ended the outer loop
    trace: List[Dict[str, object]] = dataclasses.field(default_factory=list)
    # cross-network surrogate transfer (compiler/surrogate_store.py):
    # {"store": path|None, "warm_hw_rows": int, "warm_sw_rows": int,
    #  "hw_rows_saved": int, "warm_seeded": bool} — all zero/absent on a
    # cold run (old documents deserialize with the default)
    surrogates: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the winning partition: {"k": int, "cuts": [...], "assignment":
    # {task_name: stage index}} — empty on pre-v2 documents
    partition: Dict[str, object] = dataclasses.field(default_factory=dict)
    k_chips: int = 1
    # transfer-aware early stop bookkeeping ({} = did not trigger):
    # {"round", "stable_refits", "skipped_candidates", "measurements_saved"}
    early_stop: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the measurement transport's final stats in the reference's documents;
    # the port measures in-process (the fabric is ROADMAP item 14), so its
    # own reports carry {} — kept so documents cross between the packages
    executor_stats: Dict[str, object] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------- queries
    @property
    def hw_config(self) -> Dict[str, int]:
        """The single shared geometry — only defined for K=1 reports (the
        v1 accessor every single-chip consumer keeps using)."""
        if len(self.hw_configs) != 1:
            raise ValueError(
                f"hw_config is only defined for K=1 reports; this one has "
                f"{len(self.hw_configs)} chips — use hw_configs")
        return self.hw_configs[0]

    def verify_shared_hardware(self) -> bool:
        """True iff every layer's mapping runs on its assigned stage's
        hardware config (for K=1: the SAME config everywhere — the
        co-optimization invariant the per-layer-fantasy sum violates)."""
        assign = self.partition.get("assignment", {})
        return all(
            layer["hardware"] == self.hw_configs[int(assign.get(name, 0))]
            for name, layer in self.layers.items())

    def measurements_to(self, target_latency: float) -> Optional[int]:
        """Full cumulative measurement spend (every candidate, every
        layer) at the first time the search reached ``target_latency``
        (None if it never did) — the sample-efficiency readout the
        transfer benchmark compares cold vs warm-started runs on.  Rows
        carrying a within-candidate ``trajectory`` resolve the hit inside
        the candidate's session; old documents fall back to
        candidate-granularity ``cum_measurements``."""
        for row in self.trace:
            if "network_latency" not in row:
                continue  # early-stop marker rows
            cum = int(row["cum_measurements"])
            base = cum - int(row.get("new_measurements", 0))
            for paid, lat in row.get("trajectory", []):
                if float(lat) <= target_latency:
                    return base + int(paid)
            if float(row["best_so_far"]) <= target_latency:
                return cum
        return None

    def progress(self) -> List[Tuple[int, float]]:
        """Best-so-far frontier over measurement spend:
        (cum_measurements, network_latency) rows where a candidate
        improved on everything evaluated before it (v1's ``pareto()``)."""
        out: List[Tuple[int, float]] = []
        best = float("inf")
        for row in self.trace:
            if "network_latency" not in row:
                continue
            if row["network_latency"] < best:
                best = float(row["network_latency"])
                out.append((int(row["cum_measurements"]), best))
        return out

    def pareto(self) -> List[Tuple[float, float]]:
        """Multi-objective frontier over the evaluated candidates:
        non-dominated (network_latency, chip area) points, latency
        ascending — what a heterogeneous partition trades silicon
        against.  Old documents without per-row ``area_mm2`` degenerate
        to the single best-latency point at area 0."""
        pts = sorted({(float(r["network_latency"]),
                       float(r.get("area_mm2", 0.0)))
                      for r in self.trace if "network_latency" in r})
        out: List[Tuple[float, float]] = []
        best_area = float("inf")
        for lat, area in pts:
            if area < best_area:
                out.append((lat, area))
                best_area = area
        return out

    # --------------------------------------------------------------- (de)ser
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        if len(self.hw_configs) == 1:
            # keep the v1 field in serialized K=1 documents (benchmarks,
            # dashboards, and the golden regression anchor read it)
            d["hw_config"] = dict(self.hw_configs[0])
        return d

    @staticmethod
    def from_dict(d: Dict) -> "NetworkReport":
        d = dict(d)
        if "hw_configs" not in d and "hw_config" in d:
            d["hw_configs"] = [d["hw_config"]]  # pre-v2 document
        fields = {f.name for f in dataclasses.fields(NetworkReport)}
        return NetworkReport(**{k: v for k, v in d.items() if k in fields})

    def summary(self) -> str:
        chips = " | ".join(", ".join(f"{k}={v}" for k, v in cfg.items())
                           for cfg in self.hw_configs)
        k = len(self.hw_configs)
        stage = f"{k}-chip pipeline" if k > 1 else "chip"
        return (f"{self.algo}: {self.network} on {stage} [{chips}] -> "
                f"{self.network_latency * 1e6:.1f} us over {self.n_layers} "
                f"layers ({self.hw_candidates} hw candidate(s), "
                f"{self.total_measurements} measurements, "
                f"{self.wall_time_s:.1f}s)")
