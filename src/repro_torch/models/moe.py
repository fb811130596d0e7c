"""Mixture-of-Experts FFN (token-choice top-k router) in PyTorch.

The port of the reference's ``repro.models.moe``, same parameters, same
math.  Two execution strategies, selected by ``cfg.moe_impl``:

* ``dense``    -- every expert computes every token, the router's
                  probabilities zero out the unselected ones (exact top-k
                  math; the reduced configs use it);
* ``dropping`` -- capacity-based dispatch in token groups (the GSPMD MoE):
                  one-hot dispatch and combine tensors of (groups,
                  group_tokens, E, capacity); a token past its expert's
                  capacity is dropped from that expert.

The router runs in fp32 (its weight is fp32 whatever the model's dtype).
The norm goes through the RMSNorm kernel (``use_kernel``); the expert
einsums are ``torch.einsum``, as they are outside any Pallas kernel in the
reference.  Each function returns ``(x + out, aux)``: aux is the
Switch-style load-balancing loss the trainer weights.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _winit, rmsnorm

# leaves kept in fp32 whatever the model's param dtype (the reference's)
FP32_LEAVES = ("router",)
# a list to which every router call appends its tokens' expert sets (top-k
# indices sorted, (tokens, k)), or None: how a comparison of two paths
# counts the tokens whose experts differ
route_log = None
# a list of expert sets, as ``route_log`` records them, that router calls
# take in order (one entry a call) instead of their own top-k, or None: how
# a comparison of two paths holds both to one routing
route_replay = None


def _experts(gen: torch.Generator, n: int, shape, fan_in: int, dtype,
             device) -> torch.Tensor:
    """(n, *shape) expert weights, drawn an expert at a time: a draw of
    all at once would hold them in fp32 beside their cast (jamba's 16
    experts of 8192 x 24576: 12.9 GB more)."""
    w = torch.empty((n, *shape), dtype=dtype, device=device)
    for e in range(n):
        w[e] = _winit(gen, shape, fan_in, dtype, device)
    return w


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, device) -> Params:
    return {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "router": _winit(gen, (d_model, n_experts), d_model, torch.float32,
                         device),
        "w_gate": _experts(gen, n_experts, (d_model, d_ff), d_model, dtype,
                           device),
        "w_up": _experts(gen, n_experts, (d_model, d_ff), d_model, dtype,
                         device),
        "w_down": _experts(gen, n_experts, (d_ff, d_model), d_ff, dtype,
                           device),
    }


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified, and the zero tokens of a padded group tie on every
    expert)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(h: torch.Tensor, p: Params, top_k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (probs (..., E) with only the top-k nonzero and
    renormalized, idx (..., k), aux), all in fp32."""
    logits = torch.matmul(h.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, top_k)
    if route_replay is not None:
        top_i = route_replay.pop(0).reshape(top_i.shape).to(top_i.device)
        top_p = probs.gather(-1, top_i)
    if route_log is not None:
        route_log.append(top_i.reshape(-1, top_k).sort(dim=-1).values)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    e = logits.shape[-1]
    mask = F.one_hot(top_i, e).to(probs.dtype)              # (..., k, E)
    sparse_p = torch.einsum("...ke,...k->...e", mask, top_p)
    # Switch load-balance loss: E * sum_e f_e * p_e
    f = mask.sum(-2).reshape(-1, e).mean(dim=0)              # fraction routed
    pbar = probs.reshape(-1, e).mean(dim=0)
    aux = e * (f * pbar).sum()
    return sparse_p, top_i, aux


def moe_dense(x: torch.Tensor, p: Params, top_k: int,
              use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    sparse_p, _, aux = _router(h, p, top_k)
    dt = x.dtype
    g = F.silu(torch.einsum("...d,edf->...ef", h, p["w_gate"].to(dt)))
    u = torch.einsum("...d,edf->...ef", h, p["w_up"].to(dt))
    y = torch.einsum("...ef,efd->...ed", g * u, p["w_down"].to(dt))
    out = torch.einsum("...ed,...e->...d", y, sparse_p.to(dt))
    return x + out, aux


def capacity(group_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Tokens an expert takes from one group (at least 4)."""
    return max(int(group_tokens * top_k / n_experts * capacity_factor), 4)


def moe_dropping(x: torch.Tensor, p: Params, top_k: int,
                 capacity_factor: float = 1.25, group_size: int = 2048,
                 use_kernel: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch (GSPMD MoE). x: (B, S, D).

    The tokens are cut into groups of ``min(group_size, n)``; the last
    group is padded with zero tokens, which route and take capacity like
    any other (after every real token of their group, so they never push
    one out) and count in aux, as in the reference."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    dt = x.dtype
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    tokens = h.reshape(-1, d)
    n = tokens.shape[0]
    g_sz = min(group_size, n)
    n_groups = -(-n // g_sz)
    pad = n_groups * g_sz - n
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    grp = tokens.reshape(n_groups, g_sz, d)

    sparse_p, top_i, aux = _router(grp, p, top_k)           # (G, T, E)
    cap = capacity(g_sz, top_k, e, capacity_factor)

    # position of each token within its expert's capacity buffer
    routed = F.one_hot(top_i, e).sum(2)                      # (G, T, E)
    pos_in_expert = routed.cumsum(1) - routed
    keep = pos_in_expert < cap
    # jax.nn.one_hot gives a zero row past cap; F.one_hot raises there, so
    # clamp, and let the keep mask zero those rows
    disp = (F.one_hot(pos_in_expert.clamp(max=cap - 1), cap).to(dt)
            * (routed * keep)[..., None].to(dt))             # (G, T, E, C)
    comb = disp * sparse_p[..., None].to(dt)                 # weighted

    xin = torch.einsum("gtec,gtd->gecd", disp, grp)          # (G, E, C, D)
    gact = F.silu(torch.einsum("gecd,edf->gecf", xin, p["w_gate"].to(dt)))
    uact = torch.einsum("gecd,edf->gecf", xin, p["w_up"].to(dt))
    yout = torch.einsum("gecf,efd->gecd", gact * uact, p["w_down"].to(dt))
    out = torch.einsum("gtec,gecd->gtd", comb, yout)         # (G, T, D)
    out = out.reshape(-1, d)[:n].reshape(b, s, d)
    return x + out, aux


def moe_block(x: torch.Tensor, p: Params, cfg, use_kernel: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe_impl == "dense":
        return moe_dense(x, p, cfg.moe_top_k, use_kernel=use_kernel)
    return moe_dropping(x, p, cfg.moe_top_k, cfg.moe_capacity_factor,
                        cfg.moe_group_size, use_kernel=use_kernel)

