"""Transformer building blocks of the LM serving and training paths.

The port of the reference's ``repro.models.layers``: norms, projections,
rotary and sinusoidal positions, init helpers, the MLPs, KV-chunked
attention with its custom backward, the self and cross attention
blocks, and decode attention against a KV cache (full and
ring-buffer).  Parameters are
plain dicts of tensors, as in the reference; layouts are the reference's
((B, S, H, D) attention, (in, out) projection weights).

Two functions route through the hand-written kernels and take
``use_kernel`` (default True): :func:`rmsnorm` (``kernels.rmsnorm``,
differentiable) and :func:`attention_block` (prefill attention through
``kernels.ops.attention``, the flash kernel).  With ``use_kernel=False``
they run the plain path: ``rmsnorm_plain`` and the reference model's own
:func:`chunked_attention`.  The training forward (``train=True``) always
attends through :func:`chunked_attention`, whose backward is written out;
the flash kernel is forward-only.  Cross attention (queries of the text,
keys and values of an encoder's longer sequence) also runs through
:func:`chunked_attention` on every path, as the reference computes it
outside its Pallas kernel: the flash kernel takes one sequence length
for q and k.  Projections and decode attention are
einsums, as they are outside any Pallas kernel in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as _rmsnorm

Params = Dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------------------- basic ops

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool = True) -> torch.Tensor:
    """The RMSNorm kernel's function (fp32 math, one cast to x's dtype)."""
    return _rmsnorm.rmsnorm(x.contiguous(), w, eps, use_kernel=use_kernel)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(s: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(s, d) sin (even columns) / cos (odd columns) positions, computed
    in fp32 and cast once to ``dtype``."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((s, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


# ------------------------------------------------------------- init helpers

def _winit(gen: torch.Generator, shape, fan_in: int, dtype,
           device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool, dtype,
                   device) -> Params:
    hq, hkv = n_heads * head_dim, n_kv_heads * head_dim
    p = {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "wq": _winit(gen, (d_model, hq), d_model, dtype, device),
        "wk": _winit(gen, (d_model, hkv), d_model, dtype, device),
        "wv": _winit(gen, (d_model, hkv), d_model, dtype, device),
        "wo": _winit(gen, (hq, d_model), hq, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((hq,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv,), dtype=dtype, device=device)
    return p


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, variant: str,
             dtype, device) -> Params:
    ones = torch.ones((d_model,), dtype=dtype, device=device)
    if variant == "swiglu":
        return {"ln": ones,
                "w_gate": _winit(gen, (d_model, d_ff), d_model, dtype, device),
                "w_up": _winit(gen, (d_model, d_ff), d_model, dtype, device),
                "w_down": _winit(gen, (d_ff, d_model), d_ff, dtype, device)}
    return {"ln": ones,  # gelu (whisper-style)
            "w_in": _winit(gen, (d_model, d_ff), d_model, dtype, device),
            "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_out": _winit(gen, (d_ff, d_model), d_ff, dtype, device),
            "b_out": torch.zeros((d_model,), dtype=dtype, device=device)}


def mlp(x: torch.Tensor, p: Params, variant: str = "swiglu",
        use_kernel: bool = True) -> torch.Tensor:
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    if variant == "swiglu":
        g = F.silu(dense(h, p["w_gate"]))
        u = dense(h, p["w_up"])
        return x + dense(g * u, p["w_down"])
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(dense(h, p["w_in"], p["b_in"]), approximate="tanh")
    return x + dense(h, p["w_out"], p["b_out"])


# -------------------------------------------------------- chunked attention
#
# Flash-style attention with a *manual* backward (the reference's
# custom_vjp, as a torch.autograd.Function).  Autograd through the chunk
# loop would save the per-chunk probabilities -> O(S^2) residuals, which is
# what flash attention exists to avoid.  The forward saves only
# (q, k, v, out, logsumexp) = O(S); the backward re-scans the KV chunks,
# recomputing the probabilities from the saved logsumexp.  This is jnp
# code in the reference, outside any Pallas kernel, so einsums are its
# counterpart here; the flash kernel has no backward and serves prefill.

def _mask_for(ci: int, chunk: int, rows: torch.Tensor, sk: int,
              causal: bool, window: Optional[int]) -> torch.Tensor:
    cols = ci * chunk + torch.arange(chunk, device=rows.device)
    mask = (cols[None, :] < sk).expand(rows.shape[0], chunk)
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])
    if window is not None:
        mask = mask & (cols[None, :] > rows[:, None] - window)
    return mask  # (Sq, chunk)


def _chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int,
            q_offset: int):
    """What both passes share: the chunk width, the chunk count, k and v
    padded with zeros to whole chunks, q in fp32 pre-scaled by 1/sqrt(D)
    as (B, Sq, HKV, G, D), and the rows' absolute positions."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, sq, hkv, hq // hkv, d)
    rows = q_offset + torch.arange(sq, device=q.device)
    return chunk, n_chunks, k, v, qg, rows


def _chunked_attn_fwd(q, k, v, causal, window, chunk, q_offset):
    """Returns (out (B,Sq,HQ,D), lse (B,KV,G,Sq))."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    chunk, n_chunks, k, v, qg, rows = _chunks(q, k, v, chunk, q_offset)
    m = torch.full(qg.shape[:1] + qg.shape[2:4] + (sq,), NEG_INF,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (d,), device=q.device)
    for ci in range(n_chunks):
        kc = k[:, ci * chunk:(ci + 1) * chunk].float()
        vc = v[:, ci * chunk:(ci + 1) * chunk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)
        mask = _mask_for(ci, chunk, rows, sk, causal, window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vc)
        m = m_new
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    out = acc / lsafe[..., None]
    lse = m + torch.log(lsafe)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return out, lse


def _chunked_attn_bwd(q, k, v, out, lse, dout, causal, window, chunk,
                      q_offset):
    """(dq, dk, dv) from the saved (q, k, v, out, lse), one KV chunk at a
    time: P from the logsumexp, ``delta = sum(dout * out)``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    chunk, n_chunks, kp, vp, qg, rows = _chunks(q, k, v, chunk, q_offset)
    dog = dout.float().reshape(b, sq, hkv, group, d).permute(0, 2, 3, 1, 4)
    og = out.float().reshape(b, sq, hkv, group, d).permute(0, 2, 3, 1, 4)
    delta = (dog * og).sum(dim=-1)                     # (B,KV,G,Sq)
    dq = torch.zeros((b, sq, hkv, group, d), device=q.device)
    dk = torch.empty((b, n_chunks * chunk, hkv, d), device=q.device)
    dv = torch.empty_like(dk)
    for ci in range(n_chunks):
        cs = slice(ci * chunk, (ci + 1) * chunk)
        kf, vf = kp[:, cs].float(), vp[:, cs].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
        mask = _mask_for(ci, chunk, rows, sk, causal, window)
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
        dv[:, cs] = torch.einsum("bhgqk,bhgqd->bkhd", p, dog)
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dog, vf)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
        dk[:, cs] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)  # qg is scaled
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk[:, :sk].to(k.dtype),
            dv[:, :sk].to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, lse = _chunked_attn_fwd(q, k, v, causal, window, chunk,
                                     q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_attn_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention, KV-chunked: the reference's training-path
    attention with its custom backward.  q: (B, Sq, HQ, D), k, v:
    (B, Sk, HKV, D); q is scaled before Q K^T.  Memory O(Sq * chunk) in
    both passes.  ``q_offset``: absolute position of q[0] (prefill
    continuation).  Where grad mode is on and an input requires grad it
    runs as an autograd Function (forward saves q, k, v, out, logsumexp);
    otherwise the forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _ChunkedAttention.apply(q, k, v, causal, window, chunk,
                                       q_offset)
    return _chunked_attn_fwd(q, k, v, causal, window, chunk, q_offset)[0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
              causal: bool = True, window: Optional[int] = None,
              use_kernel: bool = True, train: bool = False) -> torch.Tensor:
    """Prefill attention: the flash kernel (``use_kernel``) or the
    reference model's chunked attention (the plain path).  ``train``: the
    training forward's attention, always :func:`chunked_attention` (the
    flash kernel has no backward)."""
    if use_kernel and not train:
        return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=cfg.attn_chunk)


def heads(h: torch.Tensor, p: Params, name: str, n_heads: int,
          head_dim: int) -> torch.Tensor:
    """One projection (``w<name>``, with ``b<name>`` where the block has
    it) of a normed (B, S, D_model) input, as (B, S, n_heads, head_dim)."""
    b, s, _ = h.shape
    return dense(h, p["w" + name], p.get("b" + name)).reshape(
        b, s, n_heads, head_dim)


def qkv(h: torch.Tensor, p: Params, cfg) -> Tuple[torch.Tensor, ...]:
    """The three projections of a normed (B, S, D_model) input, as
    (B, S, heads, head_dim)."""
    return (heads(h, p, "q", cfg.n_heads, cfg.head_dim),
            heads(h, p, "k", cfg.n_kv_heads, cfg.head_dim),
            heads(h, p, "v", cfg.n_kv_heads, cfg.head_dim))


def attention_block(x: torch.Tensor, p: Params, cfg,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None,
                    use_kernel: bool = True, train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full attention block (prefill and training path). x: (B, S,
    D_model).  Returns (x + attention output, k, v): the roped keys and
    the values are what the decode cache keeps.  ``train``: see
    :func:`attention`."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    q, k, v = qkv(h, p, cfg)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, cfg, causal=causal, window=window,
                    use_kernel=use_kernel, train=train)
    return x + dense(out.reshape(b, s, -1), p["wo"]), k, v


def cross_attention_block(x: torch.Tensor, p: Params, cfg,
                          kv: Tuple[torch.Tensor, torch.Tensor],
                          use_kernel: bool = True) -> torch.Tensor:
    """Cross attention block (prefill and training path): q from this
    block's norm (``use_kernel``: the RMSNorm kernel) and ``wq``, no rope;
    ``kv``: an encoder's (B, Sk, HKV, D) keys and values.  Non-causal,
    through :func:`chunked_attention` on every path (Sk is not q's
    length).  Returns x + the attention output."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    q = heads(h, p, "q", cfg.n_heads, cfg.head_dim)
    out = chunked_attention(q, *kv, causal=False, chunk=cfg.attn_chunk)
    return x + dense(out.reshape(b, s, -1), p["wo"])


# ------------------------------------------------------------ decode (KV$)

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, HQ, D); caches: (B, S_max, HKV, D); cache_len: () or (B,).
    Scores and the weighted sum accumulate in fp32, as the reference's
    ``preferred_element_type``.
    """
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = (q * scale).reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    idx = torch.arange(smax, device=q.device)
    length = torch.as_tensor(cache_len, device=q.device).expand(b)
    mask = idx[None, :] < length[:, None]
    if window is not None:
        mask &= idx[None, :] >= torch.clamp(length[:, None] - window, min=0)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", (p / l).to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, position,
                    ring: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token at ``position`` (scalar or per-sequence (B,)), in
    place, and return the caches.

    ``ring``: modulo wraparound (sliding-window caches store only the last
    ``S_max`` tokens).  Otherwise the position is clamped into the cache,
    as the reference's ``dynamic_update_slice`` clamps its start index (a
    free batch slot keeps counting past the end).
    """
    b, smax = k_cache.shape[0], k_cache.shape[1]
    pos = torch.as_tensor(position, device=k_cache.device).expand(b).long()
    pos = pos % smax if ring else pos.clamp(0, smax - 1)
    rows = torch.arange(b, device=k_cache.device)
    k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def decode_attention_ring(q, k_cache, v_cache, position,
                          window: int) -> torch.Tensor:
    """Decode against a ring-buffer window cache (mixtral SWA long-decode).

    The cache holds the last ``S_max`` = window tokens; all valid once full.
    """
    smax = k_cache.shape[1]
    filled = torch.clamp(torch.as_tensor(position, device=q.device) + 1,
                         max=smax)
    return decode_attention(q, k_cache, v_cache, filled, window=None)
