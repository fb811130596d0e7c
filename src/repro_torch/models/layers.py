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

Under a device mesh (``repro_torch.train.steps.build_sharded_*``) the
parameters, batch and cache are DTensors placed by
``repro_torch.dist.sharding``, and ops dispatch through DTensor, as GSPMD
partitions the reference's jitted step.  Three things are done by hand
(GSPMD does them silently):

  * the activation constraint: :func:`set_batch_axes` names the batch
    axes (and the sequence axis under sequence parallelism), and
    :func:`constrain_batch` redistributes the residual stream to that
    placement where the reference calls ``with_sharding_constraint``;
  * :func:`heads` replicates a projection over the model axis before
    splitting it into heads wherever the head count does not divide
    that axis (DTensor cannot unflatten a dim sharded mid-head);
  * the kernels see local tensors: the norm takes each rank's whole rows
    (:func:`rmsnorm`), attention each rank's batch rows and heads, every
    q head beside the kv heads it reads (:func:`local_heads`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as _rmsnorm

Params = Dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------- activation placement

_BATCH_AXES: Optional[Tuple[str, ...]] = None
_SEQ_AXIS: Optional[str] = None
_SEQ_DIVISOR: int = 1
_TP_AXIS: str = "model"


def set_batch_axes(axes, seq_axis: Optional[str] = None,
                   seq_divisor: int = 1, tp_axis: str = "model") -> None:
    """The mesh axes of the activations' batch dim (the reference's
    ``set_batch_axes``), the residual stream's sequence axis under sequence
    parallelism (Megatron-SP), and the tensor-parallel axis whose heads
    :func:`local_heads` splits.  Without DTensors nothing reads them."""
    global _BATCH_AXES, _SEQ_AXIS, _SEQ_DIVISOR, _TP_AXIS
    _BATCH_AXES = axes
    _SEQ_AXIS = seq_axis
    _SEQ_DIVISOR = max(seq_divisor, 1)
    _TP_AXIS = tp_axis


def _axes(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _placements(mesh, dims: Dict[int, Any]) -> list:
    """DTensor placements of ``{tensor dim: mesh axes}``: ``Shard(d)`` on
    each named mesh dim, ``Replicate()`` on the others."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for d, axes in dims.items():
        for a in _axes(axes):
            if a in names:
                out[names.index(a)] = Shard(d)
    return out


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` on the residual stream:
    a DTensor x redistributed to its batch dim over the batch axes (and
    its sequence dim over the sequence axis, where it divides), every
    other mesh axis replicated, a pending partial sum reduced.  Plain
    tensors, and no axes set, pass through."""
    if not isinstance(x, DTensor) or (_BATCH_AXES is None
                                      and _SEQ_AXIS is None):
        return x
    dims = {0: _BATCH_AXES}
    if (_SEQ_AXIS is not None and x.ndim == 3
            and x.shape[1] % _SEQ_DIVISOR == 0 and x.shape[1] > 1):
        dims[1] = _SEQ_AXIS
    return x.redistribute(x.device_mesh, _placements(x.device_mesh, dims))


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """A DTensor x with each rank's rows whole: a pending partial sum
    reduced and a sharded last dim gathered, the other dims left where
    they are.  Plain tensors pass through."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() or (p.is_shard()
                                            and p.dim == x.ndim - 1)
          else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def _tp_index(mesh, n_heads: int) -> Optional[int]:
    """The tensor-parallel axis's mesh dim where ``n_heads`` divides it;
    None where it does not, or the mesh has no such axis."""
    names = list(mesh.mesh_dim_names)
    if _TP_AXIS not in names:
        return None
    i = names.index(_TP_AXIS)
    return i if n_heads % mesh.size(i) == 0 else None


# ---------------------------------------------------------------- basic ops

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool = True) -> torch.Tensor:
    """The RMSNorm kernel's function (fp32 math, one cast to x's dtype).

    A DTensor x keeps its rows where they are; a pending partial sum is
    reduced and a sharded last dim gathered first, and the kernel runs on
    each rank's local rows with the whole weight.  The weight's gradient
    is a partial sum over the mesh dims that split the rows."""
    if not isinstance(x, DTensor):
        return _rmsnorm.rmsnorm(x.contiguous(), w, eps, use_kernel=use_kernel)
    x = whole_rows(x)
    mesh, pl = x.device_mesh, x.placements
    if isinstance(w, DTensor):
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if p.is_shard() else Replicate()
                             for p in pl])
    out = _rmsnorm.rmsnorm(x.to_local().contiguous(), w, eps,
                           use_kernel=use_kernel)
    return DTensor.from_local(out, mesh, pl, run_check=False)


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
    if isinstance(q, DTensor):
        return local_heads(lambda ql, kl, vl: attention(
            ql, kl, vl, cfg, causal, window, use_kernel, train),
            q, (k, v), cfg.n_heads, cfg.n_kv_heads)
    if use_kernel and not train:
        return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=cfg.attn_chunk)


def head_placements(mesh, n_heads: int) -> list:
    """Where a (B, S, H, D) attention operand lives for the kernels: its
    batch over the batch axes, its heads over the tensor-parallel axis
    where ``n_heads`` divides it, every other mesh axis replicated."""
    dims: Dict[int, Any] = {0: _BATCH_AXES}
    if _tp_index(mesh, n_heads) is not None:
        dims[2] = _TP_AXIS
    return _placements(mesh, dims)


def local_heads(fn, q: DTensor, kvs, n_heads: int, n_kv_heads: int,
                caches=(), extra=()) -> DTensor:
    """``fn(q, *kvs, *caches, *extra)`` on each rank's local tensors, its
    output (B, S, HQ, D) placed as q.

    q and the kv operands are redistributed to :func:`head_placements`
    (their own head counts).  Where q's heads are split over the model
    axis and the kv heads are not (qwen2's 12/2 heads on a 4-way axis),
    each rank takes the kv heads its q heads read, and the kv gradients
    are partial sums over that axis.  ``caches`` (decode caches, written
    in place) must already lie at the kv placement; ``extra`` (DTensors of
    one value a row, such as positions) is cut to the rank's batch rows."""
    mesh = q.device_mesh
    qp, kp = head_placements(mesh, n_heads), head_placements(mesh,
                                                             n_kv_heads)
    q = q.redistribute(mesh, qp)
    kvs = [t.redistribute(mesh, kp) for t in kvs]
    tp = _tp_index(mesh, n_heads)
    split = tp is not None and _tp_index(mesh, n_kv_heads) is None
    kgrad = [Partial() if split and i == tp else p for i, p in enumerate(kp)]
    ql = q.to_local()
    kls = [t.to_local(grad_placements=kgrad) for t in kvs]
    cls = []
    for c in caches:
        if tuple(c.placements) != tuple(kp):
            raise ValueError(f"a cache at {c.placements} where the kv "
                             f"heads live at {tuple(kp)}")
        cls.append(c.to_local())
    rows = _placements(mesh, {0: _BATCH_AXES})
    xls = [t.redistribute(mesh, rows).to_local() for t in extra]
    if split:
        h = ql.shape[2]
        first = mesh.get_local_rank(tp) * h
        idx = (first + torch.arange(h)) // (n_heads // n_kv_heads)
        kls = [_kv_heads(t, idx) for t in kls]
        cls = [_kv_heads(t, idx) for t in cls]
    return DTensor.from_local(fn(ql, *kls, *cls, *xls), mesh, qp,
                              run_check=False)


def _kv_heads(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kv heads ``idx`` (one a local q head, ascending) of t (dim 2):
    a slice where each of a run of heads is read by equally many q heads,
    so the rank keeps grouped-query attention; else one a q head."""
    lo, n = int(idx[0]), int(idx[-1]) - int(idx[0]) + 1
    if len(idx) % n == 0 and torch.equal(
            idx, lo + torch.arange(len(idx)) // (len(idx) // n)):
        return t[:, :, lo:lo + n]
    return t.index_select(2, idx.to(t.device))


def heads(h: torch.Tensor, p: Params, name: str, n_heads: int,
          head_dim: int) -> torch.Tensor:
    """One projection (``w<name>``, with ``b<name>`` where the block has
    it) of a normed (B, S, D_model) input, as (B, S, n_heads, head_dim).
    A DTensor projection is replicated over the model axis first wherever
    ``n_heads`` does not divide it (its columns may be split mid-head)."""
    b, s, _ = h.shape
    out = dense(h, p["w" + name], p.get("b" + name))
    mesh = out.device_mesh if isinstance(out, DTensor) else None
    if mesh is not None and _TP_AXIS in mesh.mesh_dim_names and _tp_index(
            mesh, n_heads) is None:
        i = list(mesh.mesh_dim_names).index(_TP_AXIS)
        out = out.redistribute(mesh, [Replicate() if j == i else pl
                                      for j, pl in enumerate(out.placements)])
    return out.reshape(b, s, n_heads, head_dim)


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
    length), DTensor operands on each rank's heads (:func:`local_heads`).
    Returns x + the attention output."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    q = heads(h, p, "q", cfg.n_heads, cfg.head_dim)

    def attend(ql, kl, vl):
        return chunked_attention(ql, kl, vl, causal=False,
                                 chunk=cfg.attn_chunk)
    out = (local_heads(attend, q, kv, cfg.n_heads, cfg.n_kv_heads)
           if isinstance(q, DTensor) else attend(q, *kv))
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


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                     kv_len: int, cfg, ring: bool = False,
                     window: Optional[int] = None) -> torch.Tensor:
    """A decode step's self attention: this token's k and v (B, 1, HKV, D)
    written at ``pos`` into the caches (in place, :func:`update_kv_cache`),
    then q (B, 1, HQ, D) attending to the first ``kv_len`` cache positions
    (:func:`decode_attention`, or the ring's).  DTensor operands write each
    rank's own cache rows and heads, then attend through
    :func:`local_heads`."""
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        kp = head_placements(mesh, cfg.n_kv_heads)
        rows = _placements(mesh, {0: _BATCH_AXES})
        update_kv_cache(k_cache.to_local(), v_cache.to_local(),
                        k.redistribute(mesh, kp).to_local(),
                        v.redistribute(mesh, kp).to_local(),
                        pos.redistribute(mesh, rows).to_local(), ring=ring)
        return local_heads(
            lambda ql, kc, vc, pl: _attend_cache(ql, kc, vc, pl, kv_len, cfg,
                                                 ring, window),
            q, (), cfg.n_heads, cfg.n_kv_heads, caches=(k_cache, v_cache),
            extra=(pos,))
    update_kv_cache(k_cache, v_cache, k, v, pos, ring=ring)
    return _attend_cache(q, k_cache, v_cache, pos, kv_len, cfg, ring, window)


def _attend_cache(q, k_cache, v_cache, pos, kv_len, cfg, ring, window):
    if ring:
        return decode_attention_ring(q, k_cache, v_cache, pos,
                                     cfg.swa_window)
    return decode_attention(q, k_cache[:, :kv_len], v_cache[:, :kv_len],
                            pos + 1, window=window)


def decode_attention_ring(q, k_cache, v_cache, position,
                          window: int) -> torch.Tensor:
    """Decode against a ring-buffer window cache (mixtral SWA long-decode).

    The cache holds the last ``S_max`` = window tokens; all valid once full.
    """
    smax = k_cache.shape[1]
    filled = torch.clamp(torch.as_tensor(position, device=q.device) + 1,
                         max=smax)
    return decode_attention(q, k_cache, v_cache, filled, window=None)
