"""DiGamma-style genetic search over the joint (partition, hw-tuple) space.

DiGamma (PAPERS.md) optimizes accelerator configs with a genetic
algorithm; this module is that baseline for the netopt comparison,
running over the SAME candidate space as the co-optimizer
(:class:`~repro_torch.compiler.netopt.partition.HwPartition`: contiguous
pipeline cuts + per-stage hw value-tuples) and the SAME pinned-session
evaluator, at the SAME total measurement budget — so the only difference
left is the search strategy (GBT + Confidence Sampling + refinement vs
tournament selection + crossover + mutation).  Keeping the MARL claim
honest requires exactly this control.

Budget protocol mirrors the random baseline: the co-optimizer's
``total_layer_budget()`` upper bound split evenly over the same number
of candidate evaluations netopt gets (``n_candidates + 1``, counting its
refinement pass).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

from repro_torch.compiler.netopt.loop import NetOptConfig, _Evaluator
from repro_torch.compiler.netopt.partition import HwPartition, PartitionSpace
from repro_torch.compiler.netopt.report import NetworkReport
from repro_torch.compiler.records import RecordLog
from repro_torch.compiler.surrogate_store import SurrogateStore
from repro_torch.compiler.task import TuningTask


def mutate(ps: PartitionSpace, p: HwPartition,
           rng: np.random.Generator) -> HwPartition:
    """One random gene step: either one segment's knob value moves one
    step in that segment's value table, or one cut shifts by +-1 task
    (staying strictly between its neighbors — contiguity is preserved by
    construction)."""
    n = len(ps.tasks)
    segs = p.segments(n)
    nk = ps.base.n_knobs
    value_genes = p.k * nk
    g = int(rng.integers(0, value_genes + len(p.cuts)))
    step = 1 if int(rng.integers(0, 2)) else -1
    if g < value_genes:
        j, knob = divmod(g, nk)
        ss = ps.segment_space(*segs[j])
        idx = list(ss.index_config(p.hw_values[j]))
        idx[knob] = int(np.clip(idx[knob] + step, 0,
                                len(ss.choices[knob]) - 1))
        vals = list(p.hw_values)
        vals[j] = ss.values(idx)
        return HwPartition(p.cuts, tuple(vals))
    j = g - value_genes
    cuts = list(p.cuts)
    lo = cuts[j - 1] + 1 if j > 0 else 1
    hi = cuts[j + 1] - 1 if j + 1 < len(cuts) else n - 1
    cuts[j] = int(np.clip(cuts[j] + step, lo, hi))
    # segment boundaries moved: re-clamp values onto the new segments
    return ps.canonical(tuple(cuts), p.hw_values)


def crossover(ps: PartitionSpace, a: HwPartition, b: HwPartition,
              rng: np.random.Generator) -> HwPartition:
    """Uniform crossover: cuts from one parent, each stage's values from
    either (clamped onto the child's segment tables)."""
    cuts = a.cuts if int(rng.integers(0, 2)) else b.cuts
    vals = [(a if int(rng.integers(0, 2)) else b).hw_values[j]
            for j in range(len(cuts) + 1)]
    return ps.canonical(cuts, vals)


def network_genetic_hw_tune(tasks: Iterable[TuningTask],
                            cfg: Optional[NetOptConfig] = None,
                            k_chips: Optional[int] = None,
                            population: int = 6,
                            records: Union[None, str, RecordLog] = None,
                            name: str = "network",
                            surrogates: Union[None, str,
                                              SurrogateStore] = None,
                            trace: Optional[str] = None, obs=None,
                            device=None, **fabric) -> NetworkReport:
    """DiGamma-style GA over (cuts, per-stage hw values) at netopt's
    budget: seed a population, then tournament-select two parents,
    crossover, mutate, evaluate — until the evaluation budget is spent.
    ``k_chips`` overrides ``cfg.k_chips`` (the GA is the K>=2 comparison
    point, but runs at K=1 too)."""
    cfg = cfg or NetOptConfig()
    if k_chips is not None:
        cfg = dataclasses.replace(cfg, k_chips=int(k_chips))
    ev = _Evaluator(tasks, cfg, records, name, "genetic",
                    surrogates=surrogates, trace=trace, obs=obs,
                    device=device, **fabric)
    ps = ev.pspace
    rng = np.random.default_rng(cfg.seed)
    n_evals = cfg.n_candidates + 1     # netopt's candidate count + refine
    per_layer = max(cfg.total_layer_budget() // n_evals, 1)
    try:
        with ev.obs_scope():
            fit: Dict[HwPartition, float] = {}
            for p in ps.seed_partitions(min(population, n_evals), rng):
                if p not in fit and len(fit) < n_evals:
                    fit[p] = ev.evaluate(p, per_layer, "genetic")
            attempts = 0
            while len(fit) < n_evals and attempts < 64:
                attempts += 1
                pool: List[HwPartition] = list(fit)

                def pick() -> HwPartition:  # size-2 tournament
                    i, j = rng.integers(0, len(pool), size=2)
                    a, b = pool[int(i)], pool[int(j)]
                    return a if fit[a] <= fit[b] else b

                child = mutate(ps, crossover(ps, pick(), pick(), rng), rng)
                for _ in range(8):
                    if child not in fit:
                        break
                    child = mutate(ps, child, rng)
                if child in fit:
                    child = ps.random_partition(rng)  # diversity fallback
                if child in fit:
                    continue
                fit[child] = ev.evaluate(child, per_layer, "genetic")
            return ev.report()
    finally:
        ev.close()
