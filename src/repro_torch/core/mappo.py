"""MAPPO (Multi-Agent PPO) with Centralized Training / Decentralized Execution.

Implements §2.2 of the paper:
  Eq. 1  centralized critic regression to estimated returns
  Eq. 2  Generalized Advantage Estimation
  Eq. 3  per-agent PPO-clip policy objective

The environment is the knob-adjustment process over a ``DesignSpace``,
vectorized across ``n_envs`` parallel configurations, with the *surrogate*
reward supplied by the GBT cost model (real measurements only happen on the
Confidence-Sampled subset).

The reference jits one ``lax.scan`` over the rollout; here the rollout is
a Python loop of small tensor ops on the task's device, sampling with the
Gumbel-max trick on a seeded ``torch.Generator`` and reading nothing back
to the host, and the PPO epochs use autograd.  On the card that loop
launches many tiny kernels; its time is recorded, not optimized yet.

Each episode records two spans on the ``mappo-episode`` lane of the ambient
tracer: ``mappo-rollout`` and ``mappo-ppo`` (GAE and the PPO epochs).  On
their own lane they leave the self time of the caller's span on the
session's lane whole.  Their args (``task``, ``it``, ``episode``) come
from :func:`episode_args`, so ``train_episode`` keeps the six arguments
that code standing in for it by module attribute takes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import agents as A
from repro_torch.core import cost_model as CM
from repro_torch.core.design_space import AGENTS, DesignSpace, N_KNOBS
from repro_torch.optim.adam import Adam


class EnvParams(NamedTuple):
    """Task description as tensors on the rollout's device."""
    choice_table: torch.Tensor  # (N_KNOBS, MAX_CHOICES) float32
    n_choices: torch.Tensor     # (N_KNOBS,) int64
    wfeat: torch.Tensor         # (N_WFEAT,) float32
    khkw: float                 # kernel window area (K-tile factor)
    vmem_limit: float
    penalty_lam: float
    pinned: torch.Tensor        # (N_KNOBS,) bool — DesignSpace.pin mask
    masks: Dict[str, torch.Tensor]  # per agent: actions moving no pinned knob


def env_params_from_space(space: DesignSpace, lam: float = 1e-7,
                          device=None) -> EnvParams:
    wl = space.workload
    pinned = torch.as_tensor(space.pinned_mask(), device=device)
    return EnvParams(
        choice_table=space.choice_table(device),
        n_choices=torch.as_tensor(space.n_choices, dtype=torch.long,
                                  device=device),
        wfeat=torch.as_tensor(space.workload_features(), device=device),
        khkw=float(wl.get("kh", 1) * wl.get("kw", 1)),
        vmem_limit=float(space.spec.vmem_bytes),
        penalty_lam=float(lam),
        pinned=pinned,
        masks={a: A.action_mask(a, pinned) for a in AGENTS},
    )


def config_values(env: EnvParams, config: torch.Tensor) -> torch.Tensor:
    return torch.gather(env.choice_table.expand(*config.shape[:-1], -1, -1),
                        -1, config[..., None])[..., 0]


def config_features(env: EnvParams, config: torch.Tensor) -> torch.Tensor:
    """GBT features: log2 knob values ++ workload features, (..., 18)."""
    v = torch.log2(torch.clamp(config_values(env, config), min=1.0)) / 16.0
    wf = env.wfeat.expand(*config.shape[:-1], A.N_WFEAT)
    return torch.cat([v, wf], dim=-1)


def vmem_estimate(env: EnvParams, config: torch.Tensor) -> torch.Tensor:
    """Analytical VMEM footprint (the ``area(theta)`` analog of Eq. 4)."""
    v = config_values(env, config)
    tm = torch.ceil(v[..., 0] * v[..., 5] * v[..., 6] / 8.0) * 8.0
    tk = torch.ceil(v[..., 1] * env.khkw / 128.0) * 128.0
    tn = torch.ceil(v[..., 2] / 128.0) * 128.0
    threads = torch.clamp(v[..., 3] * v[..., 4], min=1.0)
    return threads * (tm * tk + tk * tn) * 2.0 + tm * tn * 4.0


def surrogate_reward(env: EnvParams, forest: CM.Forest,
                     config: torch.Tensor) -> torch.Tensor:
    """Eq. 5 with the cost model as the execution-time surrogate.

    The GBT is trained on y = -log(latency), so its prediction is already a
    "higher is better" fitness; the VMEM hinge penalty (Eq. 4) is analytic.
    """
    pred = CM.predict(forest, config_features(env, config))
    pen = env.penalty_lam * torch.clamp(
        vmem_estimate(env, config) - env.vmem_limit, min=0.0)
    return pred - pen


@dataclasses.dataclass(frozen=True)
class MappoConfig:
    n_steps: int = 64          # step_rl (paper: 500)
    n_envs: int = 16           # parallel configurations per episode
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    lr: float = 7e-4
    vf_coef: float = 1.0
    ent_coef: float = 0.01
    epochs: int = 4


class Trajectory(NamedTuple):
    obs: Dict[str, torch.Tensor]      # per agent: (T, E, obs_dim)
    actions: Dict[str, torch.Tensor]  # per agent: (T, E)
    logps: Dict[str, torch.Tensor]    # per agent: (T, E)
    states: torch.Tensor              # (T, E, STATE_DIM)
    values: torch.Tensor              # (T, E)
    rewards: torch.Tensor             # (T, E)
    configs: torch.Tensor             # (T, E, N_KNOBS) — visited configs
    last_value: torch.Tensor          # (E,)


def sample_categorical(logits: torch.Tensor,
                       gen: torch.Generator) -> torch.Tensor:
    """Categorical draw by the Gumbel-max trick (as jax.random.categorical);
    a -1e9 masked logit never wins."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


@torch.no_grad()
def rollout(nets: A.MarlNets, gen: torch.Generator, env: EnvParams,
            forest: CM.Forest, config0: torch.Tensor,
            hp: MappoConfig) -> Trajectory:
    config = config0
    hi = env.n_choices - 1
    obs = {a: [] for a in AGENTS}
    acts = {a: [] for a in AGENTS}
    logps = {a: [] for a in AGENTS}
    states, values, rewards, configs = [], [], [], []
    for _ in range(hp.n_steps):
        step_acts = {}
        for agent in AGENTS:
            o = A.local_obs(agent, config, env.n_choices, env.wfeat)
            logits = A.masked_policy_logits(nets.policies[agent], o,
                                            env.masks[agent])
            a = sample_categorical(logits, gen)
            lp = F.log_softmax(logits, dim=-1)
            obs[agent].append(o)
            acts[agent].append(a)
            logps[agent].append(torch.gather(lp, -1, a[..., None])[..., 0])
            step_acts[agent] = a
        state = A.global_state(config, env.n_choices, env.wfeat)
        states.append(state)
        values.append(nets.critic(state))
        config = torch.minimum(torch.clamp(
            config + A.combined_deltas(step_acts), min=0), hi)
        rewards.append(surrogate_reward(env, forest, config))
        configs.append(config)
    last_value = nets.critic(A.global_state(config, env.n_choices,
                                            env.wfeat))
    st = lambda xs: torch.stack(xs)
    return Trajectory({a: st(obs[a]) for a in AGENTS},
                      {a: st(acts[a]) for a in AGENTS},
                      {a: st(logps[a]) for a in AGENTS},
                      st(states), st(values), st(rewards), st(configs),
                      last_value)


def gae(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor,
        gamma: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 — reverse-loop GAE. Returns (advantages, returns)."""
    values_tp1 = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rewards + gamma * values_tp1 - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(last_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * carry
        advs[t] = carry
    return advs, advs + values


def ppo_loss(nets: A.MarlNets, traj: Trajectory, advs: torch.Tensor,
             returns: torch.Tensor, env: EnvParams, hp: MappoConfig):
    adv_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    total_pg, total_ent = 0.0, 0.0
    for agent in AGENTS:
        # same pinned-action mask as the rollout, so ratios and entropy
        # are computed over the reachable action set only
        logits = A.masked_policy_logits(nets.policies[agent],
                                        traj.obs[agent], env.masks[agent])
        lp_all = F.log_softmax(logits, dim=-1)
        lp = torch.gather(lp_all, -1, traj.actions[agent][..., None])[..., 0]
        ratio = torch.exp(lp - traj.logps[agent])
        # Eq. 3 — clipped surrogate
        pg = torch.minimum(ratio * adv_n,
                           torch.clamp(ratio, 1 - hp.clip, 1 + hp.clip) * adv_n)
        total_pg = total_pg + pg.mean()
        total_ent = total_ent - torch.sum(torch.exp(lp_all) * lp_all,
                                          dim=-1).mean()
    v = nets.critic(traj.states)
    vloss = torch.mean(torch.square(v - returns))  # Eq. 1
    loss = -total_pg + hp.vf_coef * vloss - hp.ent_coef * total_ent
    return loss, {"pg": total_pg, "vloss": vloss, "entropy": total_ent}


EPISODE_LANE = "mappo-episode"
_episode_args: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "mappo_episode_args", default={})


@contextlib.contextmanager
def episode_args(**args):
    """The span args of the ``train_episode`` calls inside the block."""
    token = _episode_args.set(args)
    try:
        yield
    finally:
        _episode_args.reset(token)


def make_optimizer(nets: A.MarlNets, hp: MappoConfig) -> Adam:
    return Adam(list(nets.parameters()), lr=hp.lr, grad_clip_norm=1.0)


def train_episode(nets: A.MarlNets, opt: Adam, gen: torch.Generator,
                  env: EnvParams, forest: CM.Forest, hp: MappoConfig):
    """One episode: init a set of configurations, rollout, PPO update
    (``hp.epochs`` Adam steps on the whole trajectory).

    Updates ``nets``/``opt`` in place; returns (visited configs
    (T*E, N_KNOBS) on the device, stats of the last epoch)."""
    tracer, args = obs.current(), _episode_args.get()
    u = torch.rand((hp.n_envs, N_KNOBS), generator=gen, device=gen.device)
    config0 = (u * env.n_choices).long()
    with tracer.span("mappo-rollout", cat="mappo", tid=EPISODE_LANE, **args):
        traj = rollout(nets, gen, env, forest, config0, hp)
    with tracer.span("mappo-ppo", cat="mappo", tid=EPISODE_LANE, **args):
        advs, returns = gae(traj.rewards, traj.values, traj.last_value,
                            hp.gamma, hp.gae_lambda)
        for _ in range(hp.epochs):
            loss, stats = ppo_loss(nets, traj, advs, returns, env, hp)
            opt.zero_grad()
            loss.backward()
            opt.step()
    stats = {k: v.detach() for k, v in stats.items()}
    stats.update(loss=loss.detach(), mean_reward=traj.rewards.mean())
    return traj.configs.reshape(-1, N_KNOBS), stats


@torch.no_grad()
def critic_scores(nets: A.MarlNets, env: EnvParams,
                  configs: torch.Tensor) -> torch.Tensor:
    """Value-network predictions for a set of configs (used by CS)."""
    return nets.critic(A.global_state(configs, env.n_choices, env.wfeat))
