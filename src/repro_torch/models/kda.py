"""Kimi Delta Attention (KDA), Kimi Linear's linear-attention mixer, for
serving.

The equations (arXiv:2510.26692 section 3, and the published
``modeling_kimi.py``), per head of d = ``kda_head_dim`` channels, from the
normed input h:

    q, k, v = SiLU(conv(h W_q)), SiLU(conv(h W_k)), SiLU(conv(h W_v))
                  conv: causal, depthwise, ``kda_conv`` taps a channel
    q^, k^  = q / ||q||, k / ||k||            (1e-6 under the root)
    g       = -exp(A_log_h) softplus(h W_fa W_fb + dt_bias)   (d,)
    beta    = sigmoid(h W_b)_h
    S_t     = (I - beta k^ k^T) Diag(exp g) S_(t-1) + beta k^ v^T
    o_t     = S_t^T q^ / sqrt(d)
    x       = x + [RMSNorm(o) o_ln * sigmoid(h W_ga W_gb)] W_o

S (d x d) is each head's state in float32; exp g decays each of its
rows (key channels) on its own.  With u = k^T Diag(exp g) S_(t-1), the
step is S_t = Diag(exp g) S_(t-1) + beta k^ (v - u)^T: the delta rule.

Prefill (:func:`chunk_delta`) runs the recurrence a chunk of
:data:`CHUNK` tokens at a time in the WY (UT) form, in float32: within a
chunk, with G the cumulative log-decay, the pairs' decays exp(G_c - G_j)
(j <= c, exponents never positive) give A_kk and A_qk, one triangular
solve gives T = (I + strict(beta A_kk))^-1 Diag(beta), and the
chunk's pseudo-values are T v - T (exp(G) k) S; only the state passes
from chunk to chunk.  Decode (:func:`kda_decode`) reads and writes the
layer's cache entry in place: the conv tails, and S through the KDA
decode kernel (:func:`repro_torch.kernels.kda_decode.kda_recurrence`,
which does the L2 norms, the decay, the delta correction and the
rank-1 update on CUDA, or its plain step on the CPU).

The cache entry is ``{"S": (B, H, d, d) fp32, "conv_q", "conv_k",
"conv_v": (B, kda_conv - 1, H d)}``, the tails the projections' last
inputs in ``cfg.dtype``.  The caller puts each layer's work in a ``kda``
span; with a tracer on, prefill counts ``kda.prefill_chunks`` (chunks a
sequence, summed over the layers).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import kda_decode as KK
from repro_torch.models import layers as L

Params = L.Params

CHUNK = 64          # tokens a chunk of the prefill's WY form
GROUP = 8           # chunks whose pairwise decays are held at once
_STREAMS = ("q", "k", "v")


def init_kda(gen: torch.Generator, cfg, dtype, device) -> Params:
    """The input norm, W_q/W_k/W_v (D, H d), the three convs' taps (H d,
    K), the decay gate W_fa (D, r) W_fb (r, H d) with ``A_log`` (H,) and
    ``dt_bias`` (H d,) in fp32, W_b (D, H), the output gate W_ga (D, r)
    W_gb (r, H d), the output norm's weight (d,) and W_o (H d, D).
    ``A_log`` = log U(1, 16) and ``dt_bias`` the inverse softplus of a dt
    log-uniform in [0.001, 0.1] (floor 1e-4), as the published layer
    initialises them."""
    dm, h, d = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim
    r, c = cfg.kda_gate_rank, h * d
    w = lambda shape, fan_in: L._winit(gen, shape, fan_in, dtype, device)
    rand = lambda n: torch.rand((n,), generator=gen, device=device)
    p = {"ln": torch.ones((dm,), dtype=dtype, device=device)}
    for s in _STREAMS:
        p["w" + s] = w((dm, c), dm)
    for s in _STREAMS:
        p["conv_" + s] = w((c, cfg.kda_conv), cfg.kda_conv)
    p["wf_a"], p["wf_b"] = w((dm, r), dm), w((r, c), r)
    p["A_log"] = torch.log(1.0 + 15.0 * rand(h))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * rand(c)).clamp(min=1e-4)
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    p["wb"] = w((dm, h), dm)
    p["wg_a"], p["wg_b"] = w((dm, r), dm), w((r, c), r)
    p["o_ln"] = torch.ones((d,), dtype=dtype, device=device)
    p["wo"] = w((c, dm), c)
    return p


def init_state(cfg, batch: int, device) -> Params:
    """A zero cache entry of ``batch`` slots (see the module docstring)."""
    h, d = cfg.kda_heads, cfg.kda_head_dim
    entry = {"S": torch.zeros((batch, h, d, d), dtype=torch.float32,
                              device=device)}
    for s in _STREAMS:
        entry["conv_" + s] = torch.zeros((batch, cfg.kda_conv - 1, h * d),
                                         dtype=cfg.dtype, device=device)
    return entry


def l2norm(x: torch.Tensor) -> torch.Tensor:
    """x over the root of its squares' sum over the last axis (+1e-6)."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + KK.L2_EPS)


def gates(h: torch.Tensor, p: Params, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log-decay g (..., H, d) and beta (..., H), fp32, of normed
    inputs h (..., D)."""
    hn, d = cfg.kda_heads, cfg.kda_head_dim
    f = L.dense(L.dense(h, p["wf_a"]), p["wf_b"]).float()
    f = f.view(*h.shape[:-1], hn, d) + p["dt_bias"].view(hn, d)
    g = -torch.exp(p["A_log"].float())[:, None] * F.softplus(f)
    return g, torch.sigmoid(L.dense(h, p["wb"]).float())


def _output(o: torch.Tensor, h: torch.Tensor, p: Params, cfg
            ) -> torch.Tensor:
    """The gated output norm and W_o: o (..., H, d) fp32, h (..., D)."""
    gate = torch.sigmoid(L.dense(L.dense(h, p["wg_a"]), p["wg_b"]).float())
    o = (o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
         * p["o_ln"].float())
    o = o.flatten(-2) * gate
    return L.dense(o.to(h.dtype), p["wo"])


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv of x (B, S, C) with taps w (C, K), in
    fp32: out_t = sum_i w[:, i] x_(t - K + 1 + i), zeros before the
    sequence."""
    k = w.shape[1]
    out = F.conv1d(x.transpose(1, 2).float(), w.float()[:, None],
                   padding=k - 1, groups=w.shape[0])
    return out[..., :x.shape[1]].transpose(1, 2)


def _conv_step(x: torch.Tensor, tail: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """One token's conv (x (B, C)) over ``tail`` (B, K - 1, C), the
    previous inputs, which it advances in place; fp32, (B, C)
    contiguous."""
    win = torch.cat([tail, x[:, None].to(tail.dtype)], dim=1)
    out = (win.float() * w.float().t()).sum(1)
    tail.copy_(win[:, 1:])
    return out


def chunk_delta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a sequence in chunks (the module docstring's
    WY form), fp32.  q (B, S, H, d) normed and scaled, k (B, S, H, d)
    normed, v (B, S, H, dv), g (B, S, H, d), beta (B, S, H); ``state``
    (B, H, d, dv) the state before the sequence.  Returns (o (B, S, H,
    dv), the state after it).  A short last chunk is padded with k, v,
    beta and g of 0, which leave the state as it is."""
    b, s, h, d = k.shape
    n = -(-s // CHUNK)
    pad = n * CHUNK - s

    def chunks(t):  # (B, S, H, ...) -> (B, H, N, C, ...)
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        t = t.reshape(b, n, CHUNK, h, *t.shape[3:])
        return t.movedim(3, 1)

    q, k, v, g, beta = (chunks(t.float()) for t in (q, k, v, g, beta))
    G = g.cumsum(-2)                                  # (B, H, N, C, d)
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                       device=k.device).tril()        # j <= c
    a_kk = torch.empty(b, h, n, CHUNK, CHUNK, device=k.device)
    a_qk = torch.empty_like(a_kk)
    for i in range(0, n, GROUP):
        sl = slice(i, i + GROUP)
        gs = G[:, :, sl]
        # exp(G_c - G_j) for j <= c, 0 above: (.., c, j, d)
        decay = torch.exp((gs[..., :, None, :] - gs[..., None, :, :])
                          .masked_fill(~lower[..., None], float("-inf")))
        kd = (k[:, :, sl, None] * decay).transpose(-1, -2)   # (.., c, d, j)
        a_kk[:, :, sl] = (k[:, :, sl].unsqueeze(-2) @ kd).squeeze(-2)
        a_qk[:, :, sl] = (q[:, :, sl].unsqueeze(-2) @ kd).squeeze(-2)
        del decay, kd
    strict = beta[..., None] * a_kk.tril(-1)
    eye = torch.eye(CHUNK, device=k.device)
    t = torch.linalg.solve_triangular(eye + strict, torch.diag_embed(beta),
                                      upper=False, unitriangular=True)
    w = t @ (torch.exp(G) * k)                       # (B, H, N, C, d)
    u = t @ v                                        # (B, H, N, C, dv)
    qg = q * torch.exp(G)
    last = G[..., -1:, :]                            # (B, H, N, 1, d)
    kr = (k * torch.exp(last - G)).transpose(-1, -2)  # (B, H, N, d, C)
    fade = torch.exp(last).transpose(-1, -2)         # (B, H, N, d, 1)
    out = torch.empty_like(u)
    state = state.float()
    for i in range(n):
        delta = u[:, :, i] - w[:, :, i] @ state
        out[:, :, i] = qg[:, :, i] @ state + a_qk[:, :, i] @ delta
        state = fade[:, :, i] * state + kr[:, :, i] @ delta
    out = out.movedim(1, 3).reshape(b, n * CHUNK, h, -1)[:, :s]
    return out, state


def kda_block(x: torch.Tensor, p: Params, cfg, use_kernel: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill from a zero state. x: (B, S, D).  Returns (x + the
    mixer's output, the cache entry after the sequence)."""
    b, s, _ = x.shape
    hn, d = cfg.kda_heads, cfg.kda_head_dim
    h = L.rmsnorm(x, p["ln"], cfg.rms_norm_eps, use_kernel=use_kernel)
    raw = [L.dense(h, p["w" + n]) for n in _STREAMS]
    q, k, v = (F.silu(causal_conv(t, p["conv_" + n])).view(b, s, hn, d)
               for t, n in zip(raw, _STREAMS))
    g, beta = gates(h, p, cfg)
    state = torch.zeros((b, hn, d, d), dtype=torch.float32, device=x.device)
    o, state = chunk_delta(l2norm(q) / math.sqrt(d), l2norm(k), v, g, beta,
                           state)
    tr = obs.current()
    if tr.enabled:
        tr.metrics.counter("kda.prefill_chunks").inc(b * -(-s // CHUNK))
    entry = {"S": state}
    keep = cfg.kda_conv - 1
    for t, n in zip(raw, _STREAMS):
        entry["conv_" + n] = F.pad(t, (0, 0, max(0, keep - s), 0))[:, -keep:]
    return x + _output(o, h, p, cfg), entry


def kda_decode(x: torch.Tensor, p: Params, cfg, entry: Params,
               use_kernel: bool = True) -> torch.Tensor:
    """One-token step. x: (B, 1, D); ``entry``: the layer's cache entry,
    its conv tails and state advanced in place.  Returns x + the mixer's
    output."""
    b = x.shape[0]
    hn, d = cfg.kda_heads, cfg.kda_head_dim
    h = L.rmsnorm(x, p["ln"], cfg.rms_norm_eps, use_kernel=use_kernel)[:, 0]
    q, k, v = (F.silu(_conv_step(L.dense(h, p["w" + n]), entry["conv_" + n],
                                 p["conv_" + n])).view(b, hn, d)
               for n in _STREAMS)
    g, beta = gates(h, p, cfg)
    o = KK.kda_recurrence(q, k, v, g, beta, entry["S"], 1.0 / math.sqrt(d),
                          use_kernel=use_kernel)
    return x + _output(o, h, p, cfg)[:, None]
