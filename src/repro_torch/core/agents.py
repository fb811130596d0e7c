"""The three ARCO agents (Table 1/2) — observation & action encodings + nets.

Networks follow §4.1 exactly:
  policy  (per agent): 1 hidden layer, 20 neurons, ReLU; softmax output head
  critic  (shared)   : 3 hidden layers, 20 neurons each, tanh; scalar output

Each agent owns a subset of the 7 knobs and acts with a categorical action
over joint per-knob {-1, 0, +1} adjustments (3^k actions for k knobs).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.design_space import AGENT_KNOBS, AGENTS, N_KNOBS

N_WFEAT = 11  # workload feature length (design_space.workload_features)

AGENT_N_KNOBS: Dict[str, int] = {a: len(k) for a, k in AGENT_KNOBS.items()}
AGENT_N_ACTIONS: Dict[str, int] = {a: 3 ** n for a, n in AGENT_N_KNOBS.items()}
AGENT_OBS_DIM: Dict[str, int] = {a: n + N_WFEAT for a, n in AGENT_N_KNOBS.items()}
STATE_DIM = N_KNOBS + N_WFEAT


def _knob_slice(agent: str) -> slice:
    """An agent's knobs are contiguous: slicing avoids index tensors (and
    their host-to-device copies) on the rollout's hot path."""
    k = AGENT_KNOBS[agent]
    return slice(k[0], k[-1] + 1)


def _dense(n_in: int, n_out: int, gen: torch.Generator, scale=None) -> nn.Linear:
    """He-normal weights (``scale`` overrides), zero bias, as the reference."""
    layer = nn.Linear(n_in, n_out)
    scale = scale if scale is not None else math.sqrt(2.0 / n_in)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((n_out, n_in), generator=gen) * scale)
        layer.bias.zero_()
    return layer


class Policy(nn.Module):
    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 20,
                 gen: torch.Generator = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator()
        self.h = _dense(obs_dim, hidden, gen)
        self.out = _dense(hidden, n_actions, gen, scale=0.01)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.h(obs)))


class Critic(nn.Module):
    def __init__(self, state_dim: int, hidden: int = 20,
                 gen: torch.Generator = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator()
        self.h1 = _dense(state_dim, hidden, gen)
        self.h2 = _dense(hidden, hidden, gen)
        self.h3 = _dense(hidden, hidden, gen)
        self.out = _dense(hidden, 1, gen, scale=0.01)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.h1(state))
        h = torch.tanh(self.h2(h))
        h = torch.tanh(self.h3(h))
        return self.out(h)[..., 0]


class MarlNets(nn.Module):
    """One policy per agent plus the shared centralized critic."""

    def __init__(self, gen: torch.Generator = None):
        super().__init__()
        self.policies = nn.ModuleDict({
            a: Policy(AGENT_OBS_DIM[a], AGENT_N_ACTIONS[a], gen=gen)
            for a in AGENTS})
        self.critic = Critic(STATE_DIM, gen=gen)


def init_marl_params(seed: int, device=None) -> MarlNets:
    """Seeded networks (drawn on the CPU, then moved to ``device``,
    default ``cuda``)."""
    return MarlNets(torch.Generator().manual_seed(seed)).to(
        resolve_device(device))


@torch.no_grad()
def load_dense(layer: nn.Linear, p) -> None:
    """Copy one reference dense layer (numpy ``{"w": (in, out), "b"}``,
    applied as ``x @ w + b``) into ``layer``."""
    layer.weight.copy_(torch.from_numpy(np.array(p["w"], np.float32).T))
    layer.bias.copy_(torch.from_numpy(np.array(p["b"], np.float32)))


def load_policy(policy: Policy, tree: Dict) -> None:
    load_dense(policy.h, tree["h"])
    load_dense(policy.out, tree["out"])


def load_critic(critic: Critic, tree: Dict) -> None:
    for name in ("h1", "h2", "h3", "out"):
        load_dense(getattr(critic, name), tree[name])


def params_from_jax(tree: Dict, device=None) -> MarlNets:
    """The reference's ``init_marl_params`` tree (numpy leaves) as
    :class:`MarlNets`."""
    nets = MarlNets()
    for a in AGENTS:
        load_policy(nets.policies[a], tree[a])
    load_critic(nets.critic, tree["critic"])
    return nets.to(resolve_device(device))


# ---------------------------------------------------------------- encodings

def knob_positions(config: torch.Tensor,
                   n_choices: torch.Tensor) -> torch.Tensor:
    """Normalized knob positions in [0,1]; config (..., N_KNOBS) int."""
    denom = torch.clamp(n_choices.float() - 1.0, min=1.0)
    return config.float() / denom


def local_obs(agent: str, config: torch.Tensor, n_choices: torch.Tensor,
              wfeat: torch.Tensor) -> torch.Tensor:
    pos = knob_positions(config, n_choices)
    own = pos[..., _knob_slice(agent)]
    wf = wfeat.expand(*config.shape[:-1], N_WFEAT)
    return torch.cat([own, wf], dim=-1)


def global_state(config: torch.Tensor, n_choices: torch.Tensor,
                 wfeat: torch.Tensor) -> torch.Tensor:
    pos = knob_positions(config, n_choices)
    wf = wfeat.expand(*config.shape[:-1], N_WFEAT)
    return torch.cat([pos, wf], dim=-1)


def decode_action(agent: str, action: torch.Tensor) -> torch.Tensor:
    """Categorical action -> per-knob deltas in {-1,0,+1}, (..., k)."""
    digits = []
    a = action
    for _ in range(AGENT_N_KNOBS[agent]):
        digits.append(a % 3 - 1)
        a = a // 3
    return torch.stack(digits[::-1], dim=-1).long()


def delta_table(agent: str) -> np.ndarray:
    """Static (n_actions, k) table of the per-knob deltas each categorical
    action decodes to (same base-3 encoding as ``decode_action``)."""
    a = np.arange(AGENT_N_ACTIONS[agent])
    digits = []
    for _ in range(AGENT_N_KNOBS[agent]):
        digits.append(a % 3 - 1)
        a = a // 3
    return np.stack(digits[::-1], axis=-1).astype(np.int32)


def action_mask(agent: str, pinned: torch.Tensor) -> torch.Tensor:
    """(n_actions,) bool — actions that move no *pinned* knob (an
    all-pinned agent keeps exactly the no-op action)."""
    tab = torch.as_tensor(delta_table(agent), device=pinned.device)
    own = pinned[_knob_slice(agent)]
    return torch.all((tab == 0) | ~own, dim=-1)


def masked_policy_logits(policy: Policy, obs: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Policy logits with the actions ``mask`` (an ``action_mask``) rules
    out set to -1e9 (a finite sentinel: softmax underflows it to exactly 0
    without inf*0 NaNs)."""
    return torch.where(mask, policy(obs), -1e9)


def combined_deltas(actions: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Merge per-agent deltas into a full (..., N_KNOBS) delta vector."""
    shape = actions[AGENTS[0]].shape
    out = torch.zeros((*shape, N_KNOBS), dtype=torch.long,
                      device=actions[AGENTS[0]].device)
    for agent in AGENTS:
        out[..., _knob_slice(agent)] = decode_action(agent, actions[agent])
    return out
