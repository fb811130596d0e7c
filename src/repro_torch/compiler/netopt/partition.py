"""Heterogeneous K-accelerator partitions — netopt v2's candidate space.

The v1 outer search proposed ONE hardware value-tuple for the whole
network.  A :class:`HwPartition` generalizes that to the MATCHA/DiGamma
setting: the ordered task list is split at ``k - 1`` contiguous cut
points into pipeline stages, and each stage gets its own accelerator
config from that stage's own :class:`~repro_torch.compiler.netopt.hwspace.
HwCandidateSpace` (value unions over the stage's layers only).
Contiguity is the default enumeration constraint — a stage must be a
pipeline-realizable prefix-to-suffix slab, not an arbitrary subset.

``k = 1`` is the regression anchor: a single-segment partition delegates
every operation (features, seeding, enumeration, tags) to the v1
single-chip space, so the partition-generic loop reproduces the
pre-refactor behavior bit-for-bit.

The reward is pipeline-aware end-to-end latency: the slowest stage's
multiplicity-weighted layer sum, plus the inter-stage transfer of each
boundary activation over ICI (:func:`repro_torch.hw.analytical.
interchip_transfer_s`).  For ``k = 1`` this reduces exactly to v1's
weighted sum.  The area axis of the multi-objective Pareto is the sum of
per-chip :func:`~repro_torch.hw.analytical.chip_area_mm2` proxies.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.compiler.netopt.hwspace import (HwCandidateSpace, N_HW_FEAT,
                                           hw_dict, hw_tag)
from repro_torch.compiler.task import TuningTask
from repro_torch.hw import analytical
from repro_torch.hw.tpu_spec import DEFAULT, TpuSpec

MAX_K = 3  # K in {1, 2, 3}: beyond 3 stages the toy pipelines fragment


@dataclasses.dataclass(frozen=True)
class HwPartition:
    """One candidate: contiguous cut points + one hw value-tuple per
    segment.  ``cuts`` are the ``k - 1`` interior task indices where a
    new stage starts (ascending, in ``[1, n_tasks - 1]``); ``hw_values``
    has one entry per stage."""

    cuts: Tuple[int, ...]
    hw_values: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        if len(self.hw_values) != len(self.cuts) + 1:
            raise ValueError(f"{len(self.cuts)} cuts need "
                             f"{len(self.cuts) + 1} hw tuples, got "
                             f"{len(self.hw_values)}")

    @property
    def k(self) -> int:
        return len(self.hw_values)

    def segments(self, n_tasks: int) -> List[Tuple[int, int]]:
        """Per-stage ``[start, end)`` task ranges."""
        bounds = (0,) + self.cuts + (n_tasks,)
        return [(bounds[i], bounds[i + 1]) for i in range(self.k)]

    def tags(self) -> Tuple[str, ...]:
        """Per-segment record tags.  K=1 keeps the v1 ``hw[...]`` tag
        (same task names, same record keys — warm resume across the
        refactor); K>=2 appends the segment: ``hw[...]#seg0``."""
        if self.k == 1:
            return (hw_tag(self.hw_values[0]),)
        return tuple(f"{hw_tag(v)}#seg{j}"
                     for j, v in enumerate(self.hw_values))

    def to_dict(self) -> Dict[str, object]:
        return {"k": self.k, "cuts": list(self.cuts),
                "hw": [hw_dict(v) for v in self.hw_values]}


class PartitionSpace:
    """The joint (cuts x per-segment hw values) candidate space over one
    ordered task list.  Composes one :class:`HwCandidateSpace` per
    contiguous segment (cached — segments recur across cut positions) on
    top of the shared ``base`` space (the v1 all-tasks union, which also
    bounds every segment's tables).

    Features: ``k = 1`` -> the v1 14-dim layout unchanged; ``k >= 2`` ->
    per-segment 14-dim blocks (log2 values ++ segment-local aggregate
    descriptor) ++ ``k`` segment multiplicity weights, ``k * 15`` dims
    total — which is also what keys the surrogate-store variant (rows of
    different ``dim`` never mix).
    """

    def __init__(self, tasks: Iterable[TuningTask], k_chips: int = 1,
                 spec: TpuSpec = DEFAULT):
        self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("PartitionSpace needs at least one task")
        self.k = max(1, min(int(k_chips), len(self.tasks), MAX_K))
        self.spec = spec
        self.base = HwCandidateSpace.from_tasks(self.tasks)
        self._segspaces: Dict[Tuple[int, int], HwCandidateSpace] = {}
        self._cuts: List[Tuple[int, ...]] = list(
            itertools.combinations(range(1, len(self.tasks)), self.k - 1))

    # ------------------------------------------------------------ geometry
    @property
    def n_features(self) -> int:
        return N_HW_FEAT if self.k == 1 else self.k * (N_HW_FEAT + 1)

    def all_cuts(self) -> List[Tuple[int, ...]]:
        return list(self._cuts)

    def segment_space(self, start: int, end: int) -> HwCandidateSpace:
        key = (int(start), int(end))
        if key not in self._segspaces:
            self._segspaces[key] = HwCandidateSpace.from_tasks(
                self.tasks[key[0]:key[1]])
        return self._segspaces[key]

    def canonical(self, cuts: Sequence[int],
                  values: Sequence[Sequence[int]]) -> HwPartition:
        """Clamp arbitrary per-segment values to each segment's own value
        tables (log2-nearest, like ``DesignSpace.pin``) so equal
        partitions compare equal."""
        cuts = tuple(int(c) for c in cuts)
        p = HwPartition(cuts, tuple(tuple(int(x) for x in v)
                                    for v in values))
        out = []
        for (a, b), v in zip(p.segments(len(self.tasks)), p.hw_values):
            ss = self.segment_space(a, b)
            out.append(ss.values(ss.index_config(v)))
        return HwPartition(cuts, tuple(out))

    # ------------------------------------------------------------ features
    def features(self, p: HwPartition) -> np.ndarray:
        """Dispatches on the *partition's* k (an evaluator built at
        ``k_chips=2`` still scores the single-chip baselines' K=1
        candidates in the v1 14-dim layout)."""
        if p.k == 1:
            return self.base.features(p.hw_values[0])
        total = float(sum(t.multiplicity for t in self.tasks))
        blocks, weights = [], []
        for (a, b), v in zip(p.segments(len(self.tasks)), p.hw_values):
            blocks.append(self.segment_space(a, b).features(v))
            weights.append(
                sum(t.multiplicity for t in self.tasks[a:b]) / total)
        return np.concatenate(
            blocks + [np.asarray(weights, np.float32)]).astype(np.float32)

    # ------------------------------------------------------------- seeding
    def balanced_cuts(self) -> Tuple[int, ...]:
        """Cuts that split the multiplicity-weighted layer count as
        evenly as k contiguous stages allow — the partition analog of the
        default chip."""
        n = len(self.tasks)
        if self.k == 1:
            return ()
        cum = np.cumsum([t.multiplicity for t in self.tasks]).astype(float)
        total = cum[-1]
        cuts, prev = [], 0
        for j in range(1, self.k):
            c = int(np.argmin(np.abs(cum[:-1] - total * j / self.k))) + 1
            c = min(max(c, prev + 1), n - (self.k - j))
            cuts.append(c)
            prev = c
        return tuple(cuts)

    def default_partition(self) -> HwPartition:
        cuts = self.balanced_cuts()
        p = HwPartition(cuts, tuple((0,) * self.base.n_knobs
                                    for _ in range(self.k)))
        vals = [self.segment_space(a, b).default_values(self.tasks[a:b])
                for a, b in p.segments(len(self.tasks))]
        return HwPartition(cuts, tuple(vals))

    def random_partition(self, rng: np.random.Generator) -> HwPartition:
        cuts = self._cuts[int(rng.integers(0, len(self._cuts)))]
        p = HwPartition(cuts, tuple((0,) * self.base.n_knobs
                                    for _ in range(self.k)))
        vals = []
        for a, b in p.segments(len(self.tasks)):
            ss = self.segment_space(a, b)
            vals.append(ss.values([int(rng.integers(0, len(c)))
                                   for c in ss.choices]))
        return HwPartition(cuts, tuple(vals))

    def seed_partitions(self, n: int,
                        rng: np.random.Generator) -> List[HwPartition]:
        """K=1: exactly the v1 seeds (same rng call sequence — the
        bit-for-bit anchor).  K>=2: balanced-cut default, the largest
        geometry on every stage (VMEM frontier probe), then random."""
        if self.k == 1:
            return [HwPartition((), (v,)) for v in
                    self.base.seed_values(n, self.tasks, rng)]
        out = [self.default_partition()]
        largest = self.canonical(
            self.balanced_cuts(),
            [tuple(int(c[-1]) for c in self.base.choices)] * self.k)
        if largest not in out:
            out.append(largest)
        attempts = 0
        while len(out) < n and attempts < 64:
            cand = self.random_partition(rng)
            if cand not in out:
                out.append(cand)
            attempts += 1
        return out[:max(n, 1)]

    # --------------------------------------- CS encoding (sampled pool)
    @property
    def n_choices(self) -> np.ndarray:
        """Per-slot choice counts of the encoded layout:
        ``[cut_id] ++ k * base-space knob indices``."""
        return np.asarray(
            [len(self._cuts)]
            + [len(c) for c in self.base.choices] * self.k, np.int32)

    def encode(self, p: HwPartition) -> np.ndarray:
        vec = [self._cuts.index(p.cuts)]
        for v in p.hw_values:
            vec.extend(int(i) for i in self.base.index_config(v))
        return np.asarray(vec, np.int64)

    def decode(self, vec: Sequence[int]) -> HwPartition:
        """Inverse of :meth:`encode`, total over out-of-range inputs
        (Confidence Sampling's mode synthesis can produce any index
        combination): clamp the cut id, clamp each knob index to the base
        table, then canonicalize onto the segment tables."""
        vec = np.asarray(vec, np.int64)
        cuts = self._cuts[int(np.clip(vec[0], 0, len(self._cuts) - 1))]
        nk = self.base.n_knobs
        vals = []
        for j in range(self.k):
            idx = vec[1 + j * nk: 1 + (j + 1) * nk]
            idx = [int(np.clip(i, 0, len(c) - 1))
                   for i, c in zip(idx, self.base.choices)]
            vals.append(self.base.values(idx))
        return self.canonical(cuts, vals)

    def candidate_pool(self, seed: int, limit: int = 256
                       ) -> List[HwPartition]:
        """Deterministic sampled enumeration for the outer search (the
        full ``cuts x values^k`` product is too large to score): every
        cut position with per-segment defaults (the cut axis is covered
        exactly), topped up with seeded random draws."""
        rng = np.random.default_rng(seed)
        pool: List[HwPartition] = []
        seen = set()
        for cuts in self._cuts:
            p = HwPartition(cuts, tuple((0,) * self.base.n_knobs
                                        for _ in range(self.k)))
            vals = [self.segment_space(a, b).default_values(self.tasks[a:b])
                    for a, b in p.segments(len(self.tasks))]
            p = HwPartition(cuts, tuple(vals))
            if p not in seen:
                seen.add(p)
                pool.append(p)
        attempts = 0
        while len(pool) < limit and attempts < 4 * limit:
            p = self.random_partition(rng)
            if p not in seen:
                seen.add(p)
                pool.append(p)
            attempts += 1
        return pool

    # ------------------------------------------------------------- reward
    def boundary_bytes(self, p: HwPartition) -> List[float]:
        """Activation bytes crossing each of the ``k - 1`` stage
        boundaries (the output of the last task before each cut)."""
        out = []
        for _, b in p.segments(len(self.tasks))[:-1]:
            t = self.tasks[b - 1]
            out.append(analytical.activation_out_bytes(
                getattr(t.space, "kind", ""),
                getattr(t.space, "workload", {})))
        return out

    def pipeline_latency(self, p: HwPartition,
                         task_latency: Dict[str, float]) -> float:
        """End-to-end latency of the partitioned network: slowest stage's
        multiplicity-weighted sum + ICI transfer per boundary.  K=1
        degenerates to the v1 weighted sum (same tasks, same order, same
        float additions)."""
        segs = p.segments(len(self.tasks))
        stage = [sum(task_latency[t.name] * t.multiplicity
                     for t in self.tasks[a:b]) for a, b in segs]
        if p.k == 1:
            return float(stage[0])
        transfer = sum(analytical.interchip_transfer_s(bb, self.spec)
                       for bb in self.boundary_bytes(p))
        return float(max(stage) + transfer)

    def area_mm2(self, p: HwPartition) -> float:
        """Total silicon of the partition's chip set (the second Pareto
        objective)."""
        return float(sum(analytical.chip_area_mm2(*v) for v in p.hw_values))
