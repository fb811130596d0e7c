"""Multi-head latent attention (MLA), DeepSeek-V3's mixer, for serving.

The equations (arXiv:2405.04434 section 2.1, arXiv:2412.19437 section
2.1.1), with no query low-rank (Moonlight's ``q_lora_rank`` null): from
the normed input h,

    q            = h W_q                      H heads of (nope | rope)
    [c_kv | k_pe] = h W_kva                    latent r, shared rope key
    c_kv         = RMSNorm(c_kv)
    [k_nope | v] = c_kv W_kvb                 H heads of (nope | v)
    q_pe, k_pe   = rope(q_pe), rope(k_pe)     k_pe shared by every head
    o            = softmax([q_nope | q_pe] [k_nope | k_pe]^T / sqrt(d_qk)) v
    x            = x + o W_o

Prefill runs this expanded form: per-head keys of ``qk_nope + qk_rope``
(192) and values of ``v_head_dim`` (128), zero-padded to the keys' width,
through the flash kernel (one head width for q, k and v), the output
sliced back; the padding adds zeros to the sum and changes nothing.
Decode runs the absorbed form: W_kvb's key half folds into the query
(q_lat = q_nope W_UK, (B, H, r)) and its value half applies after
attention (o = (p c_kv) W_UV), so a step reads the latent cache (c_kv
normed, k_pe roped) in bfloat16 and never forms K or V: the MLA decode
kernel (:mod:`repro_torch.kernels.mla_decode`) reads each cached
position once, scores in fp32, P rounded to bf16 for ``p c_kv`` as the
flash kernel rounds P for P V.

Rope runs on the last ``qk_rope_head_dim`` columns in the half-split
layout of :func:`repro_torch.models.layers.rope`; DeepSeek's checkpoints
interleave them, which for drawn weights is a fixed permutation of the
rope columns of W_q and W_kva.  Under ``cfg.mla_nope`` (Kimi Linear's
``mla_use_nope``) those columns stay as they are, in prefill and
decode alike: q_pe and k_pe are plain projections, and the
scores still sum over all ``qk_head_dim`` columns.

The cache entry is ``{"ckv": (B, C, r), "kpe": (B, C, d_rope)}``, written
in place a token a step.  The parts of a layer run under the ambient
``repro_torch.obs`` tracer's spans (:func:`span`) and, with a tracer on,
count ``mla.cache_tokens``: latent positions a decode step reads, each
slot's own.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import mla_decode as MK
from repro_torch.models import layers as L

Params = L.Params


def span(name: Optional[str]):
    """A span of the ambient tracer (a shared no-op without one); no span
    for the name None."""
    if name is None:
        return contextlib.nullcontext()
    return obs.current().span(name, cat="lm")


def init_mla(gen: torch.Generator, cfg, dtype, device) -> Params:
    """W_q (D, H (nope + rope)), W_kva (D, r + rope), the latent's norm
    weight, W_kvb (r, H (nope + v)), W_o (H v, D), and the input norm."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    rope, vd = cfg.qk_rope_head_dim, cfg.v_head_dim
    w = lambda shape, fan_in: L._winit(gen, shape, fan_in, dtype, device)
    return {"ln": torch.ones((d,), dtype=dtype, device=device),
            "wq": w((d, h * cfg.qk_head_dim), d),
            "wkv_a": w((d, r + rope), d),
            "kv_ln": torch.ones((r,), dtype=dtype, device=device),
            "wkv_b": w((r, h * (cfg.qk_nope_head_dim + vd)), r),
            "wo": w((h * vd, d), h * vd)}


def init_latent_cache(cfg, batch: int, max_len: int, device) -> Params:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=cfg.dtype, device=device),
            "kpe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                               dtype=cfg.dtype, device=device)}


def rope_tables(positions: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rope's cos and sin at ``positions`` (..., S) for the rope part."""
    return L.rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                         cfg.dtype)


def _project(x: torch.Tensor, p: Params, cfg, tables, use_kernel: bool):
    """The input norm and the projections of x (B, S, D): q_nope (B, S,
    H, nope), q_pe roped (B, S, H, rope), c_kv normed (B, S, r), k_pe
    roped (B, S, rope); ``tables``: :func:`rope_tables` at x's positions,
    or None under NoPE (no rotation).  q_pe and k_pe are roped as one
    tensor of H + 1 heads."""
    b, s, _ = x.shape
    hn, r = cfg.n_heads, cfg.kv_lora_rank
    h = L.rmsnorm(x, p["ln"], cfg.rms_norm_eps, use_kernel=use_kernel)
    q = L.dense(h, p["wq"]).view(b, s, hn, cfg.qk_head_dim)
    kva = L.dense(h, p["wkv_a"])
    ckv = L.rmsnorm(kva[..., :r], p["kv_ln"], cfg.rms_norm_eps,
                    use_kernel=use_kernel)
    pe = torch.cat([q[..., cfg.qk_nope_head_dim:], kva[..., None, r:]],
                   dim=2)
    if tables is not None:
        pe = L.apply_rope(pe, *tables)
    return q[..., :cfg.qk_nope_head_dim], pe[:, :, :hn], ckv, pe[:, :, hn]


def mla_block(x: torch.Tensor, p: Params, cfg, positions: torch.Tensor,
              use_kernel: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill, the expanded form. x: (B, S, D).  Returns (x + attention
    output, c_kv (B, S, r), k_pe (B, S, rope)): the latent cache."""
    b, s, _ = x.shape
    hn, nope, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    tables = None if cfg.mla_nope else rope_tables(positions, cfg)
    q_nope, q_pe, ckv, k_pe = _project(x, p, cfg, tables, use_kernel)
    kv = L.dense(ckv, p["wkv_b"]).view(b, s, hn, nope + vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :nope],
                   k_pe[:, :, None].expand(b, s, hn, cfg.qk_rope_head_dim)],
                  dim=-1)
    v = F.pad(kv[..., nope:], (0, cfg.qk_head_dim - vd))
    out = L.attention(q, k, v, cfg, causal=True, use_kernel=use_kernel)
    out = out[..., :vd].reshape(b, s, hn * vd)
    return x + L.dense(out, p["wo"]), ckv, k_pe


def absorbed_weights(p: Params, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """W_kvb's key half as (H, nope, r) and its value half as (H, r, v):
    views of W_kvb, which the decode step's batched products read in
    place."""
    nope = cfg.qk_nope_head_dim
    w = p["wkv_b"].view(cfg.kv_lora_rank, cfg.n_heads, nope + cfg.v_head_dim)
    return w[..., :nope].permute(1, 2, 0), w[..., nope:].permute(1, 0, 2)


def decode_state(pos: torch.Tensor, cache_len: int, cfg) -> Params:
    """What every MLA layer of one decode step shares: the slots' rows,
    their write positions (``pos`` clamped into the cache), the positions
    each attends over (int32), and :func:`rope_tables` at ``pos`` (None
    under NoPE)."""
    at = pos.long().clamp(0, cache_len - 1)
    return {"rows": torch.arange(pos.shape[0], device=pos.device), "at": at,
            "lens": (at + 1).to(torch.int32),
            "tables": None if cfg.mla_nope
            else rope_tables(pos.view(-1, 1), cfg)}


def mla_decode(x: torch.Tensor, p: Params, cfg, entry: Params,
               step: Params, kv_len: int,
               use_kernel: bool = True) -> torch.Tensor:
    """One-token step, the absorbed form. x: (B, 1, D); ``step``:
    :func:`decode_state` of the slots' positions, where their c_kv and
    k_pe are written (in place); attention reads the first ``kv_len``
    positions (at most the cache's: a free slot's position counts on past
    it), each slot's up to its own.  Returns x + attention output."""
    b = x.shape[0]
    hn = cfg.n_heads
    q_nope, q_pe, ckv, k_pe = _project(x, p, cfg, step["tables"], use_kernel)
    rows, at = step["rows"], step["at"]
    entry["ckv"][rows, at] = ckv[:, 0].to(entry["ckv"].dtype)
    entry["kpe"][rows, at] = k_pe[:, 0].to(entry["kpe"].dtype)
    tr = obs.current()
    if tr.enabled:   # a device scalar until read
        tr.metrics.counter("mla.cache_tokens").inc(step["lens"].sum())
    w_uk, w_uv = absorbed_weights(p, cfg)
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)   # (H, B, r)
    q_abs = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
    o_lat = MK.mla_attention(q_abs, entry["ckv"], entry["kpe"],
                             step["lens"], 1.0 / math.sqrt(cfg.qk_head_dim),
                             min(kv_len, entry["ckv"].shape[1]),
                             use_kernel=use_kernel)          # (B, H, r)
    out = torch.bmm(o_lat.transpose(0, 1), w_uv)            # (H, B, v)
    out = out.transpose(0, 1).reshape(b, 1, hn * cfg.v_head_dim)
    return x + L.dense(out, p["wo"])
