"""Design space for ARCO co-optimization.

A design space is a set of *knobs*, each with a discrete list of choices
(powers of two bounded by the workload), partitioned across the three agents
exactly as in Table 2 of the paper:

    hardware   agent: tile_b, tile_ci, tile_co   (GEMM-core geometry)
    scheduling agent: h_threading, oc_threading  (work parallelization)
    mapping    agent: tile_h, tile_w             (spatial blocking)

A *configuration* is an integer vector of per-knob choice indices (int64
tensors in the port, so they index directly).  Choice tables are padded to
a fixed width so value lookup, mutation and fitness evaluation are batched
tensor ops over candidate populations on any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.hw import analytical
from repro_torch.hw.tpu_spec import DEFAULT, TpuSpec

AGENTS = ("hardware", "scheduling", "mapping")

# Knob order is fixed; agents own contiguous views via AGENT_KNOBS.
KNOB_NAMES = ("tile_b", "tile_ci", "tile_co", "h_threading", "oc_threading",
              "tile_h", "tile_w")
AGENT_KNOBS: Dict[str, Tuple[int, ...]] = {
    "hardware": (0, 1, 2),
    "scheduling": (3, 4),
    "mapping": (5, 6),
}
N_KNOBS = len(KNOB_NAMES)
MAX_CHOICES = 12  # padded choice-table width


def _pow2_choices(limit: int, lo: int = 1, cap: int = MAX_CHOICES) -> List[int]:
    """Powers of two in [lo, limit]; at most ``cap`` entries (largest kept)."""
    limit = max(int(limit), lo)
    vals = [2 ** e for e in range(0, int(math.log2(limit)) + 1) if 2 ** e >= lo]
    if not vals:
        vals = [lo]
    return vals[-cap:]


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Discrete knob space + fitness oracle for one tuning task."""

    knob_names: Tuple[str, ...]
    choices: Tuple[Tuple[int, ...], ...]       # per-knob choice values
    agent_knobs: Dict[str, Tuple[int, ...]]
    workload: Dict[str, int]                   # static task description
    kind: str                                  # "conv2d" | "matmul"
    spec: TpuSpec = DEFAULT
    # per-knob pin mask set by ``pin()``: pinned knobs carry exactly one
    # choice and the MAPPO action heads mask their adjustments out.  None
    # (the default) means no knob was explicitly pinned.
    pinned: Tuple[bool, ...] = None

    # ---------------------------------------------------------- construction
    @staticmethod
    def for_conv2d(workload: Dict[str, int],
                   spec: TpuSpec = DEFAULT) -> "DesignSpace":
        oh, ow, _, _, _ = analytical.conv2d_im2col_dims(
            workload["b"], workload["h"], workload["w"], workload["ci"],
            workload["co"], workload["kh"], workload["kw"],
            workload["stride"], workload["pad"])
        choices = (
            tuple(_pow2_choices(workload["b"])),        # tile_b
            tuple(_pow2_choices(workload["ci"])),       # tile_ci
            tuple(_pow2_choices(workload["co"])),       # tile_co
            (1, 2, 4),                                  # h_threading
            (1, 2, 4),                                  # oc_threading
            tuple(_pow2_choices(oh)),                   # tile_h
            tuple(_pow2_choices(ow)),                   # tile_w
        )
        return DesignSpace(KNOB_NAMES, choices, dict(AGENT_KNOBS),
                           dict(workload), "conv2d", spec)

    @staticmethod
    def for_matmul(m: int, n: int, k: int,
                   spec: TpuSpec = DEFAULT) -> "DesignSpace":
        """Matmul task: tile_b/tile_h/tile_w jointly block M; ci->K; co->N."""
        workload = {"m": m, "n": n, "k": k}
        choices = (
            tuple(_pow2_choices(min(m, 256))),          # tile_b   (M blocking)
            tuple(_pow2_choices(k)),                    # tile_ci  (K blocking)
            tuple(_pow2_choices(n)),                    # tile_co  (N blocking)
            (1, 2, 4),                                  # h_threading
            (1, 2, 4),                                  # oc_threading
            tuple(_pow2_choices(min(m, 256))),          # tile_h   (M blocking)
            (1,),                                       # tile_w unused
        )
        return DesignSpace(KNOB_NAMES, choices, dict(AGENT_KNOBS), workload,
                           "matmul", spec)

    # ------------------------------------------------------------ properties
    @property
    def n_knobs(self) -> int:
        return len(self.knob_names)

    @property
    def n_choices(self) -> np.ndarray:
        return np.array([len(c) for c in self.choices], np.int32)

    @property
    def size(self) -> int:
        return int(np.prod([len(c) for c in self.choices]))

    def choice_table(self, device=None) -> torch.Tensor:
        """(n_knobs, MAX_CHOICES) float32 table, padded with the last value."""
        tab = np.zeros((self.n_knobs, MAX_CHOICES), np.float32)
        for i, ch in enumerate(self.choices):
            tab[i] = list(ch) + [ch[-1]] * (MAX_CHOICES - len(ch))
        return torch.tensor(tab, device=device)

    # ------------------------------------------------------- config handling
    def values(self, config: torch.Tensor) -> torch.Tensor:
        """config (..., n_knobs) int -> knob values (..., n_knobs) float."""
        tab = self.choice_table(config.device)
        return tab[torch.arange(self.n_knobs, device=config.device),
                   config.long()]

    def random_configs(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """``n`` uniform configs (n, n_knobs) int64 on ``gen``'s device."""
        maxc = torch.tensor(self.n_choices, dtype=torch.float32,
                            device=gen.device)
        u = torch.rand((n, self.n_knobs), generator=gen, device=gen.device)
        return (u * maxc).long()

    def clip(self, config: torch.Tensor) -> torch.Tensor:
        hi = torch.tensor(self.n_choices - 1, dtype=torch.long,
                          device=config.device)
        return torch.clamp(config.long(), min=torch.zeros_like(hi), max=hi)

    def apply_deltas(self, config: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
        """Apply per-knob {-1,0,+1} adjustments with bound clipping."""
        return self.clip(config.long() + deltas.long())

    def neighbor(self, gen: torch.Generator,
                 config: torch.Tensor) -> torch.Tensor:
        """Single random ±1 move on one random knob (for SA baselines)."""
        knob = torch.randint(0, self.n_knobs, (), generator=gen,
                             device=gen.device)
        delta = torch.randint(0, 2, (), generator=gen, device=gen.device) * 2 - 1
        step = torch.nn.functional.one_hot(knob, self.n_knobs) * delta
        return self.clip(config.long() + step.to(config.device))

    # ---------------------------------------------------------------- pinning
    def pinned_mask(self) -> np.ndarray:
        """(n_knobs,) bool — knobs frozen by ``pin()`` (all False if none)."""
        if self.pinned is None:
            return np.zeros(self.n_knobs, bool)
        return np.asarray(self.pinned, bool)

    def nearest_choice(self, knob: int, value: float) -> int:
        """Index of the choice closest to ``value`` in log2 distance (knob
        tables are powers of two, so log-space nearest is the natural
        rounding — an oversized value clamps to the largest choice)."""
        vals = np.asarray(self.choices[knob], np.float64)
        return int(np.argmin(np.abs(np.log2(np.maximum(vals, 1e-9))
                                    - math.log2(max(float(value), 1e-9)))))

    def pin(self, knob_idxs: Sequence[int],
            values: Sequence[float]) -> "DesignSpace":
        """Freeze knobs at fixed *values*: each pinned knob's choice list
        collapses to the single nearest available choice, and the MAPPO
        action heads mask the pinned adjustments out.  Pinning composes:
        already-pinned knobs stay pinned."""
        choices = list(self.choices)
        pinned = [bool(x) for x in self.pinned_mask()]
        for k, v in zip(knob_idxs, values):
            k = int(k)
            choices[k] = (self.choices[k][self.nearest_choice(k, v)],)
            pinned[k] = True
        return dataclasses.replace(self, choices=tuple(choices),
                                   pinned=tuple(pinned))

    # --------------------------------------------------------------- fitness
    def latency_fn(self) -> Callable[[torch.Tensor],
                                     Tuple[torch.Tensor, torch.Tensor]]:
        """fn: knob values (..., n_knobs) -> (latency_s, vmem_bytes).

        This is the *measurement oracle* (the VTA++-simulator analog)."""
        wl, spec, kind = self.workload, self.spec, self.kind

        if kind == "conv2d":
            def f(v):
                return analytical.conv2d_latency(
                    wl, v[..., 0], v[..., 5], v[..., 6], v[..., 1],
                    v[..., 2], v[..., 3], v[..., 4], spec=spec)
        elif kind == "matmul":
            def f(v):
                return analytical.gemm_latency(
                    wl["m"], wl["n"], wl["k"], v[..., 0] * v[..., 5],
                    v[..., 2], v[..., 1], v[..., 3], v[..., 4], spec=spec)
        else:  # pragma: no cover
            raise ValueError(f"unknown kind {kind}")
        return f

    def measure(self, configs: torch.Tensor) -> torch.Tensor:
        """Batched oracle measurement: (n, n_knobs) int -> latency (n,)."""
        lat, _ = self.latency_fn()(self.values(configs))
        return lat

    def fitness(self, configs: torch.Tensor) -> torch.Tensor:
        """f = 1/latency (throughput-style fitness, higher is better)."""
        return 1.0 / self.measure(configs)

    # ------------------------------------------------------------- features
    def workload_features(self) -> np.ndarray:
        """Static normalized log2 features describing the task (len 11)."""
        wl = self.workload
        if self.kind == "conv2d":
            _, _, m, n, k = analytical.conv2d_im2col_dims(
                wl["b"], wl["h"], wl["w"], wl["ci"], wl["co"], wl["kh"],
                wl["kw"], wl["stride"], wl["pad"])
            raw = [wl["b"], wl["h"], wl["w"], wl["ci"], wl["co"], wl["kh"],
                   wl["kw"], wl["stride"], m, n, k]
        else:
            m, n, k = wl["m"], wl["n"], wl["k"]
            raw = [1, 1, 1, k, n, 1, 1, 1, m, n, k]
        return (np.log2(np.maximum(np.array(raw, np.float32), 1.0)) / 16.0)

    def feature_vector(self, configs: torch.Tensor) -> torch.Tensor:
        """GBT features: log2 knob values ++ workload features, (..., 18)."""
        v = torch.log2(torch.clamp(self.values(configs), min=1.0)) / 16.0
        wf = torch.tensor(self.workload_features(), device=configs.device)
        wf = wf.expand(*configs.shape[:-1], wf.shape[0])
        return torch.cat([v, wf], dim=-1)


def reward_with_penalty(latency: torch.Tensor, vmem: torch.Tensor,
                        spec: TpuSpec = DEFAULT,
                        lam: float = 1e-7) -> torch.Tensor:
    """Eq. 5: R = 1/exec_time - P(theta), with Eq. 4 hinge penalties.

    ``area`` maps to VMEM footprint (on-chip resource), ``memory`` to HBM.
    Latency is clamped so infeasible measurements give ~0 base reward.
    """
    base = 1.0 / torch.clamp(latency, min=1e-9)
    pen = lam * torch.clamp(vmem - spec.vmem_bytes, min=0.0)
    return base - pen
