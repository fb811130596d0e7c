"""The network-wide hardware candidate space.

One accelerator serves every layer, so a hardware candidate is a vector of
knob *values* (``tile_b``, ``tile_ci``, ``tile_co`` — the GEMM-core
geometry the paper's hardware agent owns), not per-layer choice indices:
choice tables differ per layer (powers of two bounded by each workload)
but the chip is one.  The global value lists are the union of every
layer's hardware choice tables; pinning a candidate onto a layer clamps
each value to that layer's nearest feasible choice
(``DesignSpace.pin``) — a small layer simply underutilizes the shared
dimension.

Candidates are scored by a network-scope GBT over
``[log2 hw values ++ aggregate workload features]`` where the aggregate
is the multiplicity-weighted mean of the per-layer cell descriptors —
constant within one network, but what lets a hardware surrogate transfer
across networks sharing one record store.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.compiler.task import TuningTask
from repro_torch.core.design_space import AGENT_KNOBS, KNOB_NAMES

HW_KNOBS: Tuple[int, ...] = AGENT_KNOBS["hardware"]
HW_KNOB_NAMES: Tuple[str, ...] = tuple(KNOB_NAMES[k] for k in HW_KNOBS)
N_HW_FEAT = len(HW_KNOBS) + 11  # log2 values ++ aggregate cell descriptor


def hw_tag(values: Sequence[int]) -> str:
    """Stable per-candidate tag embedded in task names (and therefore in
    record rows): ``hw[b1,ci64,co128]`` — what keys per-(hw, layer) warm
    resume."""
    return "hw[" + ",".join(f"{n.split('_')[1]}{int(v)}"
                            for n, v in zip(HW_KNOB_NAMES, values)) + "]"


def hw_dict(values: Sequence[int]) -> Dict[str, int]:
    return {n: int(v) for n, v in zip(HW_KNOB_NAMES, values)}


@dataclasses.dataclass(frozen=True)
class HwCandidateSpace:
    """Global hardware-knob value lists + the aggregate network descriptor."""

    choices: Tuple[Tuple[int, ...], ...]   # per-hw-knob sorted value union
    agg_wfeat: Tuple[float, ...]           # multiplicity-weighted mean (11,)

    @staticmethod
    def from_tasks(tasks: Iterable[TuningTask]) -> "HwCandidateSpace":
        tasks = list(tasks)
        if not tasks:
            raise ValueError("HwCandidateSpace needs at least one task")
        unions: List[set] = [set() for _ in HW_KNOBS]
        for t in tasks:
            for j, k in enumerate(HW_KNOBS):
                unions[j].update(int(v) for v in t.space.choices[k])
        wsum = sum(t.multiplicity for t in tasks)
        agg = sum(t.multiplicity * np.asarray(t.descriptor(), np.float64)
                  for t in tasks) / wsum
        return HwCandidateSpace(
            choices=tuple(tuple(sorted(u)) for u in unions),
            agg_wfeat=tuple(float(x) for x in agg))

    # ------------------------------------------------------------ geometry
    @property
    def n_knobs(self) -> int:
        return len(self.choices)

    @property
    def n_choices(self) -> np.ndarray:
        return np.asarray([len(c) for c in self.choices], np.int32)

    @property
    def size(self) -> int:
        return int(np.prod([len(c) for c in self.choices]))

    def values(self, idx_config: Sequence[int]) -> Tuple[int, ...]:
        return tuple(int(self.choices[j][int(i)])
                     for j, i in enumerate(idx_config))

    def index_config(self, values: Sequence[int]) -> np.ndarray:
        """Values -> choice indices (nearest in log2, like pinning)."""
        out = np.zeros(self.n_knobs, np.int64)
        for j, v in enumerate(values):
            tab = np.log2(np.maximum(np.asarray(self.choices[j], float), 1e-9))
            out[j] = int(np.argmin(np.abs(tab - np.log2(max(float(v), 1e-9)))))
        return out

    def all_index_configs(self) -> np.ndarray:
        """(size, n_knobs) full enumeration — hardware spaces are small
        (tens to a few hundred candidates), so the outer search scores
        every candidate instead of sampling."""
        grids = np.meshgrid(*[np.arange(len(c)) for c in self.choices],
                            indexing="ij")
        return np.stack([g.reshape(-1) for g in grids], axis=1)

    # ------------------------------------------------------------ features
    def features(self, values: Sequence[int]) -> np.ndarray:
        """Network-scope GBT features: log2 hw values ++ aggregate workload
        descriptor (same normalization as ``DesignSpace.feature_vector``)."""
        v = np.log2(np.maximum(np.asarray(values, np.float64), 1.0)) / 16.0
        return np.concatenate([v, np.asarray(self.agg_wfeat)]).astype(
            np.float32)

    # ----------------------------------------------------------- seeding
    def default_values(self, tasks: Iterable[TuningTask]) -> Tuple[int, ...]:
        """Network-wide default geometry (the shared-chip analog of
        ``baselines.default_hardware_config``): MXU-native targets — batch
        tile 1, K-tile ~256 input elements under the multiplicity-weighted
        modal kernel window, N-tile ~128 — snapped to the global lists."""
        counts: Dict[int, int] = {}
        for t in tasks:
            wl = t.space.workload
            khkw = int(wl.get("kh", 1) * wl.get("kw", 1))
            counts[khkw] = counts.get(khkw, 0) + t.multiplicity
        khkw = max(counts, key=counts.get) if counts else 1
        targets = (1, max(256 // khkw, 1), 128)
        return self.values(self.index_config(targets))

    def seed_values(self, n: int, tasks: Iterable[TuningTask],
                    rng: np.random.Generator) -> List[Tuple[int, ...]]:
        """``n`` distinct round-0 candidates: the network default first
        (so the co-optimizer's candidate set always contains the frozen
        baseline's chip), the largest geometry second (probes the VMEM
        feasibility frontier), then uniform draws."""
        out = [self.default_values(tasks)]
        largest = tuple(int(c[-1]) for c in self.choices)
        if largest not in out:
            out.append(largest)
        attempts = 0
        while len(out) < min(n, self.size) and attempts < 64:
            cand = self.values([rng.integers(0, len(c))
                                for c in self.choices])
            if cand not in out:
                out.append(cand)
            attempts += 1
        return out[:max(n, 1)]
