"""Baseline tuners the paper compares against.

* ``random_tune``     — uniform random search (sanity floor).
* ``autotvm_tune``    — AutoTVM analog: GBT (xgb-reg) cost model + parallel
                        simulated annealing over predicted fitness, measuring
                        the top-b candidates per round (Table 5 setup).
* ``chameleon_tune``  — CHAMELEON analog: single-agent PPO adaptive
                        exploration + K-means adaptive sampling of candidates.

Faithful to §4.1: neither baseline explores *hardware* knobs — they run with
the default accelerator geometry (``default_hardware_config``), exactly as the
paper pins AutoTVM/CHAMELEON to the default VTA++ specification.  ARCO is the
only method allowed to co-optimize the hardware knobs.

The numpy parts (default geometry, seed and random draws, k-means) are the
reference's code and draw from the same ``np.random.Generator`` streams.  The
reference's jitted scans become loops on the tuner's ``device`` (default
``cuda``): the simulated-annealing chains step together as one batch, and the
CHAMELEON episode is a rollout of an ``nn.Module`` followed by Adam steps, as
``core/mappo.py`` runs MAPPO.  Their draws come from a ``torch.Generator``
seeded with ``cfg.seed``, so a run is reproducible on one device but not
draw-for-draw equal to the reference's threefry streams.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.compiler.oracle import AnalyticalOracle, Oracle
from repro_torch.compiler.report import Tracker, TuneReport
from repro_torch.core import agents as A
from repro_torch.core import cost_model as CM
from repro_torch.core import mappo
from repro_torch.core.design_space import AGENT_KNOBS, DesignSpace, N_KNOBS
from repro_torch.core.tuner import TunerConfig, unique_seed_batch
from repro_torch.optim.adam import Adam

HW_KNOBS = np.asarray(AGENT_KNOBS["hardware"])


def default_hardware_config(space: DesignSpace) -> np.ndarray:
    """Default accelerator geometry (the VTA++ default-spec analog).

    MXU-native: K-tile ~256 elements, N-tile ~128, batch tile 1.
    Returns per-knob choice indices for the three hardware knobs.
    """
    wl = space.workload
    khkw = wl.get("kh", 1) * wl.get("kw", 1)
    targets = {0: 1, 1: max(256 // khkw, 1), 2: 128}
    idx = np.zeros(3, np.int64)
    for j, knob in enumerate(HW_KNOBS):
        vals = np.asarray(space.choices[knob], np.float64)
        idx[j] = int(np.argmin(np.abs(np.log2(vals) - np.log2(targets[knob]))))
    return idx


def default_hardware_values(space: DesignSpace) -> np.ndarray:
    """Default accelerator geometry as knob *values* (not choice indices) —
    the form a network-wide shared hardware config takes, since choice
    tables differ per layer but the chip is one."""
    idx = default_hardware_config(space)
    return np.asarray([space.choices[k][i] for k, i in zip(HW_KNOBS, idx)],
                      np.int64)


def hw_pinned_space(space: DesignSpace,
                    values: Optional[np.ndarray] = None) -> DesignSpace:
    """The software-only subspace: hardware knobs pinned
    (``DesignSpace.pin``) at ``values`` (default geometry when None)."""
    if values is None:
        values = default_hardware_values(space)
    return space.pin(HW_KNOBS, values)


def frozen_mask_and_base(space: DesignSpace) -> Tuple[np.ndarray, np.ndarray]:
    """Index-space view of ``hw_pinned_space``: (frozen mask, base indices)
    for tuners that draw in the *full* space and overwrite the hardware
    slots (keeps their records/configs index-compatible with ARCO's)."""
    frozen = np.zeros(N_KNOBS, bool)
    frozen[HW_KNOBS] = True
    base = np.zeros(N_KNOBS, np.int64)
    base[HW_KNOBS] = default_hardware_config(space)
    return frozen, base


def _random_configs(space: DesignSpace, rng: np.random.Generator, n: int,
                    frozen: Optional[np.ndarray] = None,
                    base: Optional[np.ndarray] = None) -> np.ndarray:
    out = np.stack([rng.integers(0, len(c), size=n) for c in space.choices],
                   axis=1)
    if frozen is not None:
        out[:, frozen] = base[frozen]
    return np.unique(out, axis=0)


def _seed_configs(space: DesignSpace, rng: np.random.Generator, n: int,
                  frozen: Optional[np.ndarray] = None,
                  base: Optional[np.ndarray] = None) -> np.ndarray:
    """Exactly ``n`` distinct seed configs over the *unfrozen* knobs (space
    permitting) — same equal-seed-budget contract as ``ArcoLoop.seed``."""
    free = int(np.prod([len(c) for i, c in enumerate(space.choices)
                        if frozen is None or not frozen[i]]))
    return unique_seed_batch(
        lambda m: _random_configs(space, rng, m, frozen, base), n, free)


def _fitness_target(lat: np.ndarray) -> np.ndarray:
    return -np.log(np.maximum(lat, 1e-12))


# --------------------------------------------------------------------------
# Random search
# --------------------------------------------------------------------------

def random_tune(space: DesignSpace, cfg: TunerConfig = TunerConfig(),
                budget: Optional[int] = None,
                oracle: Optional[Oracle] = None,
                task: str = "", device=None) -> TuneReport:
    rng = np.random.default_rng(cfg.seed)
    oracle = oracle or AnalyticalOracle(space, task=task, device=device)
    frozen, base = frozen_mask_and_base(space)
    track = Tracker(task)
    budget = budget or cfg.iteration_opt * cfg.b_measure
    while track.count < budget:
        n = min(cfg.b_measure, budget - track.count)
        cand = _random_configs(space, rng, 2 * n, frozen, base)
        cand = np.asarray([c for c in cand if track.is_new(c)])
        if len(cand) == 0:
            break
        cand = cand[:n]
        lat, _ = oracle.measure(cand)
        track.record(cand, lat)
    return track.report(oracle=oracle)


# --------------------------------------------------------------------------
# AutoTVM analog: GBT + parallel simulated annealing
# --------------------------------------------------------------------------

@torch.no_grad()
def _sa_search(gen: torch.Generator, env: mappo.EnvParams, forest: CM.Forest,
               config0: torch.Tensor, frozen: torch.Tensor,
               n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel Metropolis chains maximizing the GBT-predicted fitness:
    every chain proposes one random *unfrozen* knob +-1 a step, all chains
    batched.  Returns every visited config and its fitness,
    (n_steps * n_chains, N_KNOBS) and (n_steps * n_chains,)."""
    n_chains = config0.shape[0]
    rows = torch.arange(n_chains, device=config0.device)
    logits = torch.where(frozen, -1e9, 0.0).expand(n_chains, N_KNOBS)
    hi = env.n_choices - 1
    configs = config0
    fit = mappo.surrogate_reward(env, forest, configs)
    temp = 1.0
    visited, vfit = [], []
    for _ in range(n_steps):
        knob = mappo.sample_categorical(logits, gen)
        delta = torch.randint(0, 2, (n_chains,), generator=gen,
                              device=gen.device) * 2 - 1
        prop = configs.clone()
        prop[rows, knob] += delta
        prop = torch.minimum(torch.clamp(prop, min=0), hi)
        new_fit = mappo.surrogate_reward(env, forest, prop)
        u = torch.rand((n_chains,), generator=gen, device=gen.device)
        accept = u < torch.exp(torch.clamp(
            (new_fit - fit) / max(temp, 1e-6), -50, 50))
        configs = torch.where(accept[:, None], prop, configs)
        fit = torch.where(accept, new_fit, fit)
        temp *= 0.98
        visited.append(configs)
        vfit.append(fit)
    return torch.cat(visited), torch.cat(vfit)


def autotvm_tune(space: DesignSpace, cfg: TunerConfig = TunerConfig(),
                 budget: Optional[int] = None,
                 n_chains: int = 64, sa_steps: Optional[int] = None,
                 eps_greedy: float = 0.1,
                 oracle: Optional[Oracle] = None,
                 gbt: Optional[CM.GBTModel] = None,
                 task: str = "", device=None) -> TuneReport:
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(cfg.seed)
    np_rng = np.random.default_rng(cfg.seed)
    env = mappo.env_params_from_space(space, device=device)
    oracle = oracle or AnalyticalOracle(space, task=task, device=device)
    gbt = gbt if gbt is not None else CM.GBTModel(n_rounds=cfg.gbt_rounds,
                                                  seed=cfg.seed)
    frozen_np, base = frozen_mask_and_base(space)
    frozen = torch.as_tensor(frozen_np, device=device)
    track = Tracker(task)
    budget = budget or cfg.iteration_opt * cfg.b_measure
    sa_steps = sa_steps or cfg.mappo.n_steps  # matched search effort

    seed_cfgs = _seed_configs(space, np_rng, min(cfg.b_measure, budget),
                              frozen_np, base)
    lat, feats = oracle.measure(seed_cfgs)
    track.record(seed_cfgs, lat)
    gbt.update(feats, _fitness_target(lat))

    while track.count < budget:
        forest = gbt.to_forest(device)
        c0 = _random_configs(space, np_rng, n_chains, frozen_np, base)
        c0 = np.resize(c0, (n_chains, N_KNOBS))
        visited, vfit = _sa_search(gen, env, forest,
                                   torch.as_tensor(c0, device=device),
                                   frozen, sa_steps)
        visited, vfit = visited.cpu().numpy(), vfit.cpu().numpy()
        order = np.argsort(-vfit)
        n_meas = min(cfg.b_measure, budget - track.count)
        n_rand = int(n_meas * eps_greedy)
        cand: List[np.ndarray] = []
        seen = set(track.seen)
        for i in order:
            t = tuple(visited[i])
            if t not in seen:
                seen.add(t)
                cand.append(visited[i])
            if len(cand) >= n_meas - n_rand:
                break
        rand = _random_configs(space, np_rng, n_rand + 1, frozen_np, base)
        for c in rand:
            if len(cand) >= n_meas:
                break
            if tuple(c) not in seen:
                seen.add(tuple(c))
                cand.append(c)
        if not cand:  # software knob space exhausted
            break
        cand_np = np.asarray(cand[:n_meas]).reshape(-1, N_KNOBS)
        lat, feats = oracle.measure(cand_np)
        track.record(cand_np, lat)
        gbt.update(feats, _fitness_target(lat))
    return track.report(oracle=oracle)


# --------------------------------------------------------------------------
# CHAMELEON analog: single-agent PPO + adaptive (K-means) sampling
# --------------------------------------------------------------------------

class SingleAgent(nn.Module):
    """CHAMELEON's one agent: a policy with a factored 3-way head per knob
    (the same 20-unit net as ARCO's agents) and a critic over the global
    state."""

    def __init__(self, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.policy = A.Policy(A.STATE_DIM, N_KNOBS * 3, gen=gen)
        self.critic = A.Critic(A.STATE_DIM, gen=gen)


def _init_single_agent(seed: int, device=None) -> SingleAgent:
    """Seeded agent (drawn on the CPU, then moved to ``device``)."""
    return SingleAgent(torch.Generator().manual_seed(seed)).to(
        resolve_device(device))


def single_agent_from_jax(tree, device=None) -> SingleAgent:
    """The reference's ``_init_single_agent`` tree (numpy leaves) as a
    :class:`SingleAgent`."""
    agent = SingleAgent()
    A.load_policy(agent.policy, tree["policy"])
    A.load_critic(agent.critic, tree["critic"])
    return agent.to(resolve_device(device))


def _factored_logits(agent: SingleAgent, state: torch.Tensor) -> torch.Tensor:
    return agent.policy(state).reshape(*state.shape[:-1], N_KNOBS, 3)


def _chameleon_episode(agent: SingleAgent, opt: Adam, gen: torch.Generator,
                       env: mappo.EnvParams, forest: CM.Forest,
                       frozen: torch.Tensor, base: torch.Tensor,
                       hp: mappo.MappoConfig) -> torch.Tensor:
    """Single-agent PPO over the software knobs (factorized 3-way heads):
    a rollout of ``hp.n_steps`` steps over ``hp.n_envs`` configs, then
    ``hp.epochs`` Adam steps on the clipped objective.  Updates ``agent``
    and ``opt`` in place; returns the visited configs (T*E, N_KNOBS) on
    the device."""
    u = torch.rand((hp.n_envs, N_KNOBS), generator=gen, device=gen.device)
    config = torch.where(frozen, base, (u * env.n_choices).long())
    hi = env.n_choices - 1
    states, acts, lps, values, rewards, configs = [], [], [], [], [], []
    with torch.no_grad():
        for _ in range(hp.n_steps):
            state = A.global_state(config, env.n_choices, env.wfeat)
            logits = _factored_logits(agent, state)
            a = mappo.sample_categorical(logits, gen)          # (E, K)
            lp = torch.gather(F.log_softmax(logits, dim=-1), -1,
                              a[..., None])[..., 0].sum(-1)
            deltas = torch.where(frozen, 0, a - 1)
            config = torch.minimum(torch.clamp(config + deltas, min=0), hi)
            states.append(state)
            acts.append(a)
            lps.append(lp)
            values.append(agent.critic(state))
            rewards.append(mappo.surrogate_reward(env, forest, config))
            configs.append(config)
        last_v = agent.critic(A.global_state(config, env.n_choices,
                                             env.wfeat))
    states, acts, lps = torch.stack(states), torch.stack(acts), \
        torch.stack(lps)
    advs, returns = mappo.gae(torch.stack(rewards), torch.stack(values),
                              last_v, hp.gamma, hp.gae_lambda)
    adv_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    for _ in range(hp.epochs):
        lp_all = F.log_softmax(_factored_logits(agent, states), dim=-1)
        lp = torch.gather(lp_all, -1, acts[..., None])[..., 0].sum(-1)
        ratio = torch.exp(lp - lps)
        pg = torch.minimum(ratio * adv_n,
                           torch.clamp(ratio, 1 - hp.clip, 1 + hp.clip)
                           * adv_n)
        ent = -torch.sum(torch.exp(lp_all) * lp_all, dim=-1).sum(-1).mean()
        vloss = torch.mean(torch.square(agent.critic(states) - returns))
        loss = -pg.mean() + hp.vf_coef * vloss - hp.ent_coef * ent
        opt.zero_grad()
        loss.backward()
        opt.step()
    return torch.stack(configs).reshape(-1, N_KNOBS)


def _kmeans(X: np.ndarray, k: int, rng: np.random.Generator,
            iters: int = 10) -> np.ndarray:
    """Lloyd's algorithm; returns the index of the member nearest each
    centroid (CHAMELEON's adaptive-sampling representative selection)."""
    k = min(k, len(X))
    centers = X[rng.choice(len(X), k, replace=False)].astype(np.float64)
    for _ in range(iters):
        d = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            pts = X[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    d = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
    return np.unique(d.argmin(0))


def chameleon_tune(space: DesignSpace, cfg: TunerConfig = TunerConfig(),
                   budget: Optional[int] = None,
                   oracle: Optional[Oracle] = None,
                   gbt: Optional[CM.GBTModel] = None,
                   task: str = "", device=None) -> TuneReport:
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(cfg.seed)
    np_rng = np.random.default_rng(cfg.seed)
    env = mappo.env_params_from_space(space, device=device)
    agent = _init_single_agent(cfg.seed, device)
    opt = Adam(list(agent.parameters()), lr=cfg.mappo.lr, grad_clip_norm=1.0)
    oracle = oracle or AnalyticalOracle(space, task=task, device=device)
    gbt = gbt if gbt is not None else CM.GBTModel(n_rounds=cfg.gbt_rounds,
                                                  seed=cfg.seed)
    frozen_np, base_np = frozen_mask_and_base(space)
    frozen = torch.as_tensor(frozen_np, device=device)
    base = torch.as_tensor(base_np, device=device)
    track = Tracker(task)
    budget = budget or cfg.iteration_opt * cfg.b_measure

    seed_cfgs = _seed_configs(space, np_rng, min(cfg.b_measure, budget),
                              frozen_np, base_np)
    lat, feats = oracle.measure(seed_cfgs)
    track.record(seed_cfgs, lat)
    gbt.update(feats, _fitness_target(lat))

    while track.count < budget:
        forest = gbt.to_forest(device)
        pool = [_chameleon_episode(agent, opt, gen, env, forest, frozen,
                                   base, cfg.mappo)
                for _ in range(cfg.episodes_per_iter)]
        pool_np = np.unique(torch.cat(pool).cpu().numpy(), axis=0)
        pool_np = np.asarray([c for c in pool_np if track.is_new(c)])
        if len(pool_np) == 0:
            pool_np = _random_configs(space, np_rng, cfg.b_measure, frozen_np,
                                      base_np)
            pool_np = np.asarray([c for c in pool_np if track.is_new(c)])
        if len(pool_np) == 0:  # software knob space exhausted
            break
        n_meas = min(cfg.b_measure, budget - track.count)
        # Adaptive sampling: cluster the candidate pool, measure the
        # representative nearest each centroid.
        reps = _kmeans(pool_np.astype(np.float64), n_meas, np_rng)
        cand = pool_np[reps][:n_meas].reshape(-1, N_KNOBS)
        lat, feats = oracle.measure(cand)
        track.record(cand, lat)
        gbt.update(feats, _fitness_target(lat))
    return track.report(oracle=oracle)


# --------------------------------------------------------------------------
# Network-level hardware baselines (the netopt comparison points)
# --------------------------------------------------------------------------
# Implemented on the netopt machinery (imported lazily: netopt depends on
# this module for the per-layer tuners, so a module-level import would
# close a cycle).

def network_hw_frozen_tune(tasks, cfg=None, records=None, name="network",
                           surrogates=None, device=None, **kw):
    """Network-scope hardware-frozen baseline: ONE shared default
    accelerator geometry for every layer, with the co-optimizer's entire
    per-layer measurement budget spent on software mapping under it — the
    network-scope analog of pinning AutoTVM/CHAMELEON to the default spec
    (§4.1), run with ARCO's own software agents."""
    from repro_torch.compiler.netopt import loop as _netopt
    return _netopt.network_hw_frozen_tune(tasks, cfg=cfg, records=records,
                                          name=name, surrogates=surrogates,
                                          device=device, **kw)


def network_random_hw_tune(tasks, cfg=None, n_candidates: int = 4,
                           records=None, name="network", surrogates=None,
                           device=None, **kw):
    """Network-scope random-hardware baseline: the shared-chip evaluation
    loop of netopt with uniformly drawn hardware candidates instead of the
    GBT + Confidence-Sampling outer search."""
    from repro_torch.compiler.netopt import loop as _netopt
    return _netopt.network_random_hw_tune(tasks, cfg=cfg,
                                          n_candidates=n_candidates,
                                          records=records, name=name,
                                          surrogates=surrogates,
                                          device=device, **kw)


def network_genetic_hw_tune(tasks, cfg=None, k_chips=None,
                            population: int = 6, records=None,
                            name="network", surrogates=None, device=None,
                            **kw):
    """DiGamma-style genetic baseline over the joint (partition, hw-tuple)
    space at the co-optimizer's total measurement budget."""
    from repro_torch.compiler.netopt import genetic as _genetic
    return _genetic.network_genetic_hw_tune(tasks, cfg=cfg, k_chips=k_chips,
                                            population=population,
                                            records=records, name=name,
                                            surrogates=surrogates,
                                            device=device, **kw)
