"""A plain MAPPO update: the reference of one of the tuner's episodes.

The tuner states it so (the compiler paper's section 2.2 and its own
settings): three agents, each with a policy of one hidden layer of ReLU
units and a softmax head over its joint knob moves, the moves that would
shift a pinned knob masked out; one critic of three tanh layers over the
global state.  After a rollout of ``steps`` steps in ``envs``
environments, the episode computes generalized advantage estimates
(``gamma``, ``lam``) from the critic's values and the rewards, normalizes
the advantages over the whole rollout (population standard deviation,
``+ 1e-8``), and takes ``epochs`` Adam steps on the whole rollout of

    loss = -sum over agents of mean(min(ratio * A, clip(ratio) * A))
           + vf_coef * mean((V(s) - returns)**2)
           - ent_coef * sum over agents of mean(entropy),

each step's gradients scaled to a global 2-norm of at most ``clip_norm``
(by ``min(1, clip_norm / (norm + 1e-9))``), then Adam with bias
correction: ``p -= lr * mhat / (sqrt(vhat) + eps)``.

:func:`update` follows one episode from the state it starts in: the
parameters and the optimizer's moments and step count before it, the
configurations the rollout visited, its moves, and the surrogate it
scored them with.  :func:`episode` works out the observations, states
and rewards; :func:`update` the values, the rollout's log-probabilities,
the advantages, every epoch's loss, gradients and step.  Plain PyTorch
on the CPU, in float64 with the parameters and moments kept in float32
between steps, as the tuner keeps them, or, for the control, with every
matrix product's
operands rounded to TF32 (the nearest precision below the float32 that
the tuner states, its matmuls taken with TF32 off); it imports nothing
of the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from dcoc_bench.reference import analytical, gbt

# each agent's knobs, in the knob order of ``analytical``
AGENT_KNOBS = {"hardware": (0, 1, 2), "scheduling": (3, 4), "mapping": (5, 6)}
PENALTY = 1e-7          # the reward's hinge on the VMEM footprint, a byte


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to TF32 (10 mantissa bits, to nearest, ties to even),
    as float32."""
    bits = a.float().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def positions(wl: Dict[str, int], configs: torch.Tensor) -> torch.Tensor:
    """Each knob's choice index over its last index, ++ the layer's
    features: the global state (..., 18)."""
    n = torch.tensor([len(c) for c in analytical.choices(wl)],
                     dtype=torch.float64)
    pos = configs.to(torch.float64) / torch.clamp(n - 1, min=1.0)
    layer = torch.from_numpy(gbt.layer_features(wl)).expand(
        *configs.shape[:-1], 11)
    return torch.cat([pos, layer], dim=-1)


def vmem_bytes(values: torch.Tensor, khkw: float) -> torch.Tensor:
    v = values.to(torch.float64)
    tm = torch.ceil(v[..., 0] * v[..., 5] * v[..., 6] / 8.0) * 8.0
    tk = torch.ceil(v[..., 1] * khkw / 128.0) * 128.0
    tn = torch.ceil(v[..., 2] / 128.0) * 128.0
    threads = torch.clamp(v[..., 3] * v[..., 4], min=1.0)
    return threads * (tm * tk + tk * tn) * 2.0 + tm * tn * 4.0


def moves(agent: str, action: torch.Tensor) -> torch.Tensor:
    """An agent's joint move (..., k) in {-1, 0, 1}: the base-3 digits of
    its action, the first knob's the most significant."""
    k = len(AGENT_KNOBS[agent])
    return torch.stack([(action // 3 ** (k - 1 - j)) % 3 - 1
                        for j in range(k)], dim=-1)


def episode(wl: Dict[str, int], config0: torch.Tensor,
            configs: torch.Tensor, actions: Dict[str, torch.Tensor],
            forest: gbt.Forest) -> dict:
    """What the rollout of an episode gives its update, worked out from
    the configurations it visited (``config0`` (E, 7), then ``configs``
    (T, E, 7)), the moves taken and the surrogate it was scored against:
    each step's observations, state and reward, the last state, the
    masks (no knob is pinned); ``moved_wrong``, the steps whose
    configuration is not the last one moved as the actions say."""
    hi = torch.tensor([len(c) - 1 for c in analytical.choices(wl)])
    prev = torch.cat([config0[None], configs[:-1]])
    step = torch.zeros_like(configs)
    for agent, knobs in AGENT_KNOBS.items():
        step[..., knobs[0]:knobs[-1] + 1] = moves(agent, actions[agent])
    want = torch.minimum(torch.clamp(prev + step, min=0), hi)
    state = positions(wl, prev)
    obs = {a: torch.cat([state[..., k[0]:k[-1] + 1], state[..., 7:]], -1)
           for a, k in AGENT_KNOBS.items()}
    flat = configs.reshape(-1, 7)
    values = analytical.decode(wl, flat.tolist())
    pred = gbt.predict(forest, gbt.features(wl, flat.tolist()))
    over = torch.clamp(vmem_bytes(values, wl["kh"] * wl["kw"])
                       - analytical.VMEM_BYTES, min=0.0)
    reward = (torch.from_numpy(pred) - PENALTY * over).reshape(
        configs.shape[:-1])
    return {"obs": obs, "states": state,
            "last_state": positions(wl, configs[-1]),
            "masks": {a: torch.ones(3 ** len(k), dtype=torch.bool)
                      for a, k in AGENT_KNOBS.items()},
            "actions": actions, "rewards": reward,
            "moved_wrong": int((want != configs).any(-1).sum())}


def _rounded(a: torch.Tensor) -> torch.Tensor:
    """``a`` in TF32 forward, its gradient passed through."""
    return a + (to_tf32(a) - a).detach()


def _linear(x, w, b, tf32: bool):
    if tf32:
        return _rounded(x) @ _rounded(w).T + b
    return x @ w.T + b


def policy_logits(p: Dict[str, torch.Tensor], agent: str, obs, mask,
                  tf32: bool = False):
    pre = f"policies.{agent}."
    h = torch.relu(_linear(obs, p[pre + "h.weight"], p[pre + "h.bias"],
                           tf32))
    out = _linear(h, p[pre + "out.weight"], p[pre + "out.bias"], tf32)
    return torch.where(mask, out, torch.full_like(out, -1e9))


def value(p: Dict[str, torch.Tensor], state, tf32: bool = False):
    h = state
    for name in ("h1", "h2", "h3"):
        h = torch.tanh(_linear(h, p[f"critic.{name}.weight"],
                               p[f"critic.{name}.bias"], tf32))
    return _linear(h, p["critic.out.weight"], p["critic.out.bias"],
                   tf32)[..., 0]


def advantages(rewards, values, last_value, gamma: float, lam: float):
    nxt = torch.cat([values[1:], last_value[None]])
    delta = rewards + gamma * nxt - values
    adv = torch.zeros_like(delta)
    run = torch.zeros_like(last_value)
    for t in reversed(range(len(delta))):
        run = delta[t] + gamma * lam * run
        adv[t] = run
    return adv, adv + values


def loss(p, agents: Sequence[str], ep: dict, old_logp, adv, returns, hp,
         tf32: bool = False):
    a = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    pg = ent = 0.0
    for agent in agents:
        lp_all = torch.log_softmax(policy_logits(
            p, agent, ep["obs"][agent], ep["masks"][agent], tf32), dim=-1)
        lp = lp_all.gather(-1, ep["actions"][agent][..., None])[..., 0]
        ratio = torch.exp(lp - old_logp[agent])
        clipped = torch.clamp(ratio, 1 - hp["clip"], 1 + hp["clip"])
        pg = pg + torch.minimum(ratio * a, clipped * a).mean()
        ent = ent + (-(lp_all.exp() * lp_all).sum(-1)).mean()
    v = value(p, ep["states"], tf32)
    vloss = ((v - returns) ** 2).mean()
    return -pg + hp["vf_coef"] * vloss - hp["ent_coef"] * ent


def update(ep: dict, hp: dict, tf32: bool = False) -> dict:
    """One episode's PPO epochs from its starting state ``ep``: ``params``,
    ``mu`` and ``nu`` (name -> tensor, in the optimizer's order), ``step``
    (Adam steps taken before), ``obs``/``actions``/``masks`` (agent ->
    tensor), ``states`` (T, E, S), ``last_state`` (E, S), ``rewards``
    (T, E).  Returns ``losses`` (one an epoch, before its step), the first
    epoch's gradients (``first_grads``), and the ``params``, ``mu``,
    ``nu`` after the last step."""
    dt = torch.float32 if tf32 else torch.float64
    names: List[str] = list(ep["params"])
    p = {k: v.detach().to(dt).clone() for k, v in ep["params"].items()}
    mu = [ep["mu"][k].to(dt).clone() for k in names]
    nu = [ep["nu"][k].to(dt).clone() for k in names]
    agents = list(ep["obs"])
    obs = {k: v.to(dt) for k, v in ep["obs"].items()}
    e = dict(ep, obs=obs)
    with torch.no_grad():
        old = {ag: torch.log_softmax(policy_logits(
            p, ag, obs[ag], ep["masks"][ag], tf32), -1).gather(
                -1, ep["actions"][ag][..., None])[..., 0] for ag in agents}
        vals = value(p, ep["states"].to(dt), tf32)
        last = value(p, ep["last_state"].to(dt), tf32)
        adv, ret = advantages(ep["rewards"].to(dt), vals, last,
                              hp["gamma"], hp["gae_lambda"])
    e["states"] = ep["states"].to(dt)
    losses = []
    step = int(ep["step"])
    for _ in range(hp["epochs"]):
        for v in p.values():
            v.requires_grad_(True)
        total = loss(p, agents, e, old, adv, ret, hp, tf32)
        grads = torch.autograd.grad(total, [p[k] for k in names])
        if not losses:
            first = {k: g.detach() for k, g in zip(names, grads)}
        losses.append(float(total.detach()))
        step += 1
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(hp["clip_norm"] / (norm + 1e-9), max=1.0)
            bc1 = 1 - hp["b1"] ** step
            bc2 = 1 - hp["b2"] ** step
            for k, g, m, v in zip(names, grads, mu, nu):
                g = g * scale
                m.mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
                v.mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
                p[k] = (p[k] - hp["lr"] * (m / bc1)
                        / (torch.sqrt(v / bc2) + hp["eps"])).detach()
                # parameters and moments are kept in float32 between steps
                for t in (p[k], m, v):
                    t.copy_(t.to(torch.float32))
    return {"losses": losses, "params": p, "first_grads": first,
            "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)),
            "step": step}
