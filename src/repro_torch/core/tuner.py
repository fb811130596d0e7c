"""ARCO tuning loop — Fig. 2 / Algorithm 1 of the paper.

Per tuning task (one conv layer / one GEMM):

  repeat iteration_opt times:
    MARL exploration episodes (MAPPO, CTDE) against the GBT surrogate
    Confidence Sampling picks <= b_measure high-confidence configs
    the measurement oracle evaluates them (memoized, record-persisted —
    see ``repro_torch.compiler.oracle``)
    the GBT cost model is refit on all measurements

The loop is stepwise (:class:`ArcoLoop`: ``seed()`` + ``step()``) so a
``Session`` can interleave several tasks over one *shared* GBT; each step
splits into ``step_submit()`` (explore + select + hand the batch to the
oracle) and ``collect()`` (wait, record, refit).  ``arco_tune`` is the
single-task adapter.

The MAPPO nets, the rollouts and the surrogate predictions run on the
loop's ``device`` (default ``cuda``); the GBT fit, Confidence Sampling and
the bookkeeping run on the host, as in the reference.  Random streams come
from one ``torch.Generator`` seeded with ``cfg.seed`` (plus numpy RNGs
seeded the same way), so a run is reproducible on one device, but not
draw-for-draw equal to the reference's threefry streams.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.compiler.oracle import AnalyticalOracle, Oracle, decode_config
from repro_torch.compiler.report import Tracker, TuneReport
from repro_torch.core import confidence_sampling as CS
from repro_torch.core import mappo
from repro_torch.core.agents import init_marl_params
from repro_torch.core.cost_model import GBTModel
from repro_torch.core.design_space import DesignSpace, N_KNOBS


@dataclasses.dataclass(frozen=True)
class TunerConfig:
    iteration_opt: int = 16        # Table 4
    b_measure: int = 64            # bGBT — measurements per iteration
    episodes_per_iter: int = 8     # episode_rl / iteration_opt
    mappo: mappo.MappoConfig = mappo.MappoConfig()
    gbt_rounds: int = 40
    seed: int = 0
    # Confidence-Sampling batch schedule: iteration t measures
    # round(b_measure * b_growth**(t-1)) configs, floored at
    # b_measure // 8 (>= 1).  1.0 (default) is the paper's constant batch.
    b_growth: float = 1.0

    @staticmethod
    def paper() -> "TunerConfig":
        """Full Table-4 hyper-parameters (episode_rl=128, step_rl=500)."""
        return TunerConfig(iteration_opt=16, b_measure=64,
                           episodes_per_iter=8,
                           mappo=mappo.MappoConfig(n_steps=500, n_envs=16))

    @staticmethod
    def fast() -> "TunerConfig":
        """Scaled-down budget for tests and smoke runs."""
        return TunerConfig(iteration_opt=4, b_measure=16,
                           episodes_per_iter=2,
                           mappo=mappo.MappoConfig(n_steps=24, n_envs=8),
                           gbt_rounds=16)


def unique_seed_batch(draw, n: int, space_size: int) -> np.ndarray:
    """Exactly ``n`` distinct configs (space permitting) from repeated calls
    to ``draw(n)``: unique-dedup may shrink a draw, so fresh draws top the
    batch back up — every method consumes the same seed budget."""
    out = np.unique(np.asarray(draw(n)), axis=0)
    attempts = 0
    while len(out) < min(n, space_size) and attempts < 16:
        out = np.unique(np.concatenate([out, np.asarray(draw(n))]), axis=0)
        attempts += 1
    return out[:n]


class ArcoLoop:
    """Stepwise ARCO on one task: MARL explore -> CS select -> measure ->
    GBT refit.  Oracle and GBT are injectable so a session can share them."""

    def __init__(self, space: DesignSpace, cfg: TunerConfig = TunerConfig(),
                 oracle: Optional[Oracle] = None,
                 gbt: Optional[GBTModel] = None,
                 use_cs: bool = True, task: str = "", device=None):
        self.device = resolve_device(device)
        self.space = space
        self.cfg = cfg
        self.use_cs = use_cs
        self.oracle = oracle or AnalyticalOracle(space, task=task,
                                                 device=self.device)
        self.gbt = gbt if gbt is not None else GBTModel(
            n_rounds=cfg.gbt_rounds, seed=cfg.seed)
        self.track = Tracker(task)
        self.gen = torch.Generator(self.device).manual_seed(cfg.seed)
        self.np_rng = np.random.default_rng(cfg.seed)
        self.env = mappo.env_params_from_space(space, device=self.device)
        self.nets = init_marl_params(cfg.seed, device=self.device)
        self.opt = mappo.make_optimizer(self.nets, cfg.mappo)
        self.it = 0
        self.exhausted = False
        # (configs, PendingBatch) submitted but not yet collected/refit
        self._pending = None

    # ----------------------------------------------------------- async seam
    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def pending_ready(self) -> bool:
        """True when the in-flight batch (if any) can be collected without
        blocking."""
        return self._pending is None or self._pending[1].ready()

    def collect(self, block: bool = False) -> bool:
        """Finalize the in-flight measurement batch: wait for the oracle,
        record the results, refit the GBT.  Returns False when a batch is
        still in flight and ``block`` is False; True otherwise."""
        if self._pending is None:
            return True
        cfgs, batch = self._pending
        if not block and not batch.ready():
            return False
        t0 = time.perf_counter()
        lat, feats = batch.get()
        self._pending = None
        self.track.add_active(time.perf_counter() - t0)
        self.track.record(cfgs, lat)
        t_fit = time.perf_counter()
        with obs.current().span("surrogate-refit", cat="surrogate",
                                task=self.track.task, n=len(lat)):
            self.gbt.update(feats, -np.log(np.maximum(lat, 1e-12)))
        self.track.add_active(time.perf_counter() - t_fit)
        return True

    # ------------------------------------------------------------ iteration 0
    def seed(self, budget: Optional[int] = None) -> None:
        """Seed the cost model with random measurements (an untrained
        surrogate carries no signal)."""
        self.seed_submit(budget)
        self.collect(block=True)

    def seed_submit(self, budget: Optional[int] = None) -> None:
        """Draw and submit the seed batch; ``collect()`` finalizes it."""
        if self._pending is not None:
            raise RuntimeError("seed_submit with a batch still in flight")
        t_start = time.perf_counter()
        n = self.cfg.b_measure if budget is None else min(
            self.cfg.b_measure, budget)

        def draw(m):
            return self.space.random_configs(self.gen, m).cpu().numpy()

        with obs.current().span("seed-draw", cat="select",
                                task=self.track.task, n=int(n)):
            cfgs = unique_seed_batch(draw, n, self.space.size)
        batch = self.oracle.measure_async(cfgs)
        self.track.add_active(time.perf_counter() - t_start)
        self._pending = (cfgs, batch)

    # -------------------------------------------------------- one iteration
    def step(self, budget: int) -> bool:
        """One synchronous optimization iteration; returns False once the
        search space is exhausted (nothing new to measure)."""
        out = self.step_submit(budget)
        self.collect(block=True)
        return out

    def step_submit(self, budget: int) -> bool:
        """The explore/select half of one iteration: MAPPO episodes, CS
        candidate selection, submit the batch to the oracle.  Returns False
        once the search space is exhausted."""
        if self._pending is not None:
            raise RuntimeError("step_submit with a batch still in flight")
        if self.exhausted or self.track.count >= budget:
            return not self.exhausted
        t_start = time.perf_counter()
        self.it += 1
        cfg = self.cfg
        tracer, task = obs.current(), self.track.task
        with tracer.span("forest-export", cat="surrogate", task=task,
                         it=self.it):
            forest = self.gbt.to_forest(self.device)
        pool = []
        with tracer.span("mappo-update", cat="mappo", task=task, it=self.it):
            for k in range(cfg.episodes_per_iter):
                with mappo.episode_args(task=task, it=self.it, episode=k):
                    visited, _stats = mappo.train_episode(
                        self.nets, self.opt, self.gen, self.env, forest,
                        cfg.mappo)
                pool.append(visited)
        # the pool's copy to the host waits for the episodes' device work
        with tracer.span("pool-dedup", cat="select", task=task, it=self.it):
            pool_np = np.unique(torch.cat(pool).cpu().numpy(), axis=0)

        # Confidence Sampling over the explored pool (critic-scored)
        with tracer.span("critic-score", cat="select", task=task,
                         it=self.it):
            scores = mappo.critic_scores(
                self.nets, self.env,
                torch.as_tensor(pool_np, device=self.device)).cpu().numpy()
        with tracer.span("confidence-sampling", cat="select", task=task,
                         it=self.it):
            cand = self._select(pool_np, scores, budget)
        if cand is None:  # search space exhausted
            self.exhausted = True
            self.track.add_active(time.perf_counter() - t_start)
            return False

        batch = self.oracle.measure_async(cand)
        self.track.add_active(time.perf_counter() - t_start)
        self._pending = (cand, batch)
        return True

    def _select(self, pool_np: np.ndarray, scores: np.ndarray,
                budget: int) -> Optional[np.ndarray]:
        """This iteration's batch: CS (or the uniform ablation) over the
        pool, configs this run already measured dropped and topped up from
        the pool by score; None once nothing new is left."""
        cfg = self.cfg
        b_floor = max(cfg.b_measure // 8, 1)
        b_sched = max(b_floor, int(round(cfg.b_measure
                                         * cfg.b_growth ** (self.it - 1))))
        n_meas = min(b_sched, budget - self.track.count)
        if self.use_cs:
            cand = CS.confidence_sampling(pool_np, scores, n_meas,
                                          self.space.n_choices,
                                          seed=cfg.seed + self.it)
        else:  # ablation: uniform sampling from the explored pool (Fig. 4a)
            idx = self.np_rng.choice(len(pool_np),
                                     min(n_meas, len(pool_np)),
                                     replace=False)
            cand = pool_np[idx]
        cand_list = [c for c in cand if self.track.is_new(c)]
        if len(cand_list) < n_meas:
            seen = {tuple(c) for c in cand_list}
            for c in pool_np[np.argsort(-scores)]:
                if self.track.is_new(c) and tuple(c) not in seen:
                    seen.add(tuple(c))
                    cand_list.append(c)
                if len(cand_list) >= n_meas:
                    break
        if not cand_list:
            return None
        return np.asarray(cand_list[:n_meas], np.int64).reshape(-1, N_KNOBS)

    # -------------------------------------------------------------- result
    def report(self) -> TuneReport:
        self.collect(block=True)  # never report around an in-flight batch
        settings = (decode_config(self.space, self.track.best_cfg)
                    if self.track.best_cfg is not None else None)
        return self.track.report(oracle=self.oracle, best_settings=settings)


def arco_tune(space: DesignSpace, cfg: TunerConfig = TunerConfig(),
              budget: Optional[int] = None, use_cs: bool = True,
              oracle: Optional[Oracle] = None,
              gbt: Optional[GBTModel] = None,
              task: str = "", device=None) -> TuneReport:
    """Tune one task with ARCO. ``budget`` caps total oracle measurements.

    ``use_cs=False`` ablates Confidence Sampling (Fig. 4a): candidates are
    drawn uniformly from the explored pool instead."""
    budget = budget or cfg.iteration_opt * cfg.b_measure
    loop = ArcoLoop(space, cfg, oracle=oracle, gbt=gbt, use_cs=use_cs,
                    task=task, device=device)
    loop.seed(budget)
    while loop.track.count < budget:
        if not loop.step(budget):
            break
    return loop.report()


def tune_network(tasks: Dict[str, DesignSpace],
                 tuner=arco_tune, **kw) -> Dict[str, TuneReport]:
    """Tune every (deduplicated) task of a network; returns per-task results."""
    return {name: tuner(space, **kw) for name, space in tasks.items()}
