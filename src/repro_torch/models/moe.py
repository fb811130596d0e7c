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

DeepSeek-V3's MoE (``cfg.moe_scoring == "sigmoid"``, the port's own; see
:class:`repro_torch.models.transformer.MLAConfig`) routes by sigmoid
scores: the top-k are chosen on score plus a per-expert correction bias
(``bias``, fp32, used for the choice only), weighted by their scores
normalised to sum to 1 and times ``cfg.routed_scaling``; a shared SwiGLU
(``ws_gate``/``ws_up``/``ws_down``, width ``n_shared_experts * d_ff``)
computes every token beside them.  It runs ``dense`` (the exact top-k
math, as above) or ``grouped``: a dropless dispatch that sorts the
token-expert pairs by expert, runs each expert's rows as one group of a
grouped matrix product (``torch._grouped_mm`` in bfloat16, else a loop
over the experts that have rows), and sums each token's k outputs
weighted.  With the ambient ``repro_torch.obs`` tracer on, ``grouped``
counts ``moe.experts_touched`` (experts with a row, a layer a call) and
``moe.tokens_dropped`` (pairs that reached no expert's group: 0), as
device scalars that a reader turns into numbers after a synchronize.

The expert share of expert parallelism (``cfg.n_experts_held`` of the
router's ``n_experts``, from ``cfg.experts_held_from``): the layer holds
only those experts' weights, (n_held, ...), routes over all the experts,
and computes the part of the routed sum that its own experts give, the
pairs routed to the others left out (no code stands in for the chips
that hold them); the shared expert runs whole.  ``grouped`` then counts
``moe.pairs_elsewhere`` (pairs routed to an expert not held), and
``moe.tokens_dropped`` counts held pairs that reached no group.  Where
every expert is held the dispatch is the one above, launch for launch.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
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
             dtype, device, n_held=None) -> Params:
    """The router over ``n_experts`` and the weights of ``n_held`` of
    them (default all)."""
    held = n_held or n_experts
    return {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "router": _winit(gen, (d_model, n_experts), d_model, torch.float32,
                         device),
        "w_gate": _experts(gen, held, (d_model, d_ff), d_model, dtype,
                           device),
        "w_up": _experts(gen, held, (d_model, d_ff), d_model, dtype,
                         device),
        "w_down": _experts(gen, held, (d_ff, d_model), d_ff, dtype,
                           device),
    }


def init_deepseek_extras(gen: torch.Generator, cfg, dtype, device
                         ) -> Params:
    """DeepSeek-V3's leaves beside :func:`init_moe`'s: the correction
    bias (fp32, normal with std ``cfg.route_bias_std``) and the shared
    SwiGLU of width ``n_shared_experts * d_ff``."""
    d, f = cfg.d_model, cfg.n_shared_experts * cfg.d_ff
    bias = torch.randn((cfg.n_experts,), generator=gen, device=device)
    return {"bias": bias * cfg.route_bias_std,
            "ws_gate": _winit(gen, (d, f), d, dtype, device),
            "ws_up": _winit(gen, (d, f), d, dtype, device),
            "ws_down": _winit(gen, (f, d), f, dtype, device)}


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


def route_sigmoid(h: torch.Tensor, p: Params, cfg
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router (``noaux_tc``, one group) on tokens h (N, D):
    returns (weights (N, k) fp32, expert ids (N, k)).  The choice is the
    top-k of sigmoid score + correction bias; the weights are the chosen
    scores over their sum, times ``cfg.routed_scaling``."""
    scores = torch.sigmoid(torch.matmul(h.float(), p["router"]))
    idx = torch.topk(scores + p["bias"], cfg.moe_top_k, dim=-1).indices
    if route_replay is not None:
        idx = route_replay.pop(0).reshape(idx.shape).to(idx.device)
    if route_log is not None:
        route_log.append(idx.sort(dim=-1).values)
    w = scores.gather(-1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    return w, idx


def swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    g = F.silu(torch.matmul(h, w_gate.to(dt)))
    return torch.matmul(g * torch.matmul(h, w_up.to(dt)), w_down.to(dt))


def shared_expert(h: torch.Tensor, p: Params) -> torch.Tensor:
    """The shared experts' SwiGLU on every token."""
    return swiglu(h, p["ws_gate"], p["ws_up"], p["ws_down"])


def _grouped_mm(xs: torch.Tensor, w: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[e-1]:offs[e]`` of xs times w[e], for every expert e:
    ``torch._grouped_mm`` in bfloat16, else one product an expert that
    has rows (the group ends read on the host)."""
    if xs.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        return torch._grouped_mm(xs, w.to(xs.dtype), offs=offs)
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = torch.matmul(xs[start:end], w[e].to(xs.dtype))
        start = end
    return out


def experts_grouped(h: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    p: Params, first: int = 0) -> torch.Tensor:
    """The routed experts' output (N, D) for tokens h (N, D), dropless:
    the N k token-expert pairs sorted by expert, one group an expert, each
    token's k outputs summed with its weights w (N, k) in fp32.  The
    groups' ends come from a search of the sorted experts, on the device
    (``bincount`` would read its input's largest value on the host, a
    synchronization a layer).  Where the layer holds fewer experts than
    its router scores (the share from expert ``first``), a pair routed
    elsewhere sorts after every held group and adds nothing."""
    n, k = idx.shape
    e = p["w_gate"].shape[0]
    share = e != p["router"].shape[-1]
    if share:
        local = idx.reshape(-1) - first
        experts, order = torch.where((local >= 0) & (local < e), local,
                                     e).sort(stable=True)
    else:
        experts, order = idx.reshape(-1).sort(stable=True)
    offs = torch.searchsorted(experts, torch.arange(e, device=idx.device),
                              right=True, out_int32=True)
    xs = h[order // k]
    y = _grouped_mm(F.silu(_grouped_mm(xs, p["w_gate"], offs))
                    * _grouped_mm(xs, p["w_up"], offs), p["w_down"], offs)
    if share:   # rows past the held groups: no product wrote them
        y = torch.where((experts < e)[:, None], y, 0.0)
    out = (y[order.argsort()].view(n, k, -1).float()
           * w[..., None]).sum(dim=1)
    tr = obs.current()
    if tr.enabled:
        rows = torch.diff(offs, prepend=offs.new_zeros(1))
        tr.metrics.counter("moe.experts_touched").inc((rows > 0).sum())
        if share:
            held = (experts < e).sum()
            tr.metrics.counter("moe.tokens_dropped").inc(held - offs[-1])
            tr.metrics.counter("moe.pairs_elsewhere").inc(n * k - held)
        else:
            tr.metrics.counter("moe.tokens_dropped").inc(n * k - offs[-1])
    return out.to(h.dtype)


def experts_dense(h: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                  p: Params, first: int = 0) -> torch.Tensor:
    """The same sum with every held expert computing every token (exact
    top-k math: the unchosen experts weigh 0)."""
    dt = h.dtype
    e = p["w_gate"].shape[0]
    dense_w = torch.zeros(h.shape[:-1] + (p["router"].shape[-1],),
                          device=h.device).scatter(-1, idx, w)
    dense_w = dense_w[..., first:first + e]
    g = F.silu(torch.einsum("nd,edf->nef", h, p["w_gate"].to(dt)))
    u = torch.einsum("nd,edf->nef", h, p["w_up"].to(dt))
    y = torch.einsum("nef,efd->ned", g * u, p["w_down"].to(dt))
    return torch.einsum("ned,ne->nd", y.float(), dense_w).to(dt)


def moe_deepseek(x: torch.Tensor, p: Params, cfg, use_kernel: bool = True
                 ) -> Tuple[torch.Tensor, None]:
    """DeepSeek-V3's MoE layer: x + routed experts + shared experts.
    Returns (x, None): it has no load-balance loss (``noaux_tc`` balances
    by the correction bias)."""
    if cfg.moe_impl not in ("dense", "grouped"):
        raise ValueError(f"{cfg.name}: sigmoid routing runs moe_impl dense "
                         f"or grouped, not {cfg.moe_impl!r}")
    shape = x.shape
    h = rmsnorm(x, p["ln"], cfg.rms_norm_eps,
                use_kernel=use_kernel).reshape(-1, shape[-1])
    w, idx = route_sigmoid(h, p, cfg)
    experts = experts_grouped if cfg.moe_impl == "grouped" else experts_dense
    out = experts(h, w, idx, p, cfg.experts_held_from) + shared_expert(h, p)
    return x + out.reshape(shape), None


def moe_block(x: torch.Tensor, p: Params, cfg, use_kernel: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe_scoring == "sigmoid":
        return moe_deepseek(x, p, cfg, use_kernel=use_kernel)
    if cfg.moe_impl == "dense":
        return moe_dense(x, p, cfg.moe_top_k, use_kernel=use_kernel)
    return moe_dropping(x, p, cfg.moe_top_k, cfg.moe_capacity_factor,
                        cfg.moe_group_size, use_kernel=use_kernel)

