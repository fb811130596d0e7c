"""Sequence-mixing blocks with recurrent state: Mamba, mLSTM, sLSTM.

The port of the reference's ``repro.models.ssm``, same parameters, same
math, same state layouts.  Prefill runs over the sequence in chunks of
``cfg.ssm_chunk`` steps, the last chunk padded with steps that leave the
state unchanged; decode is a single-step state update (O(1) a token).

* Mamba: within a chunk the linear recurrence ``h_t = dA_t h_{t-1} +
  dBx_t`` is a Hillis-Steele doubling scan over the chunk (log2(C) steps
  of the reference's ``associative_scan`` combine; torch has no
  ``associative_scan``).  The combine multiplies forward, so nothing ever
  divides by a cumulative product of ``dA`` (which underflows within a
  64-step chunk, since A < 0).  The products come in another order than
  the reference's tree: a few fp32 ulps apart.
* mLSTM and sLSTM: stepwise, as in the reference (their gates are
  recurrent by construction); one Python step a token.

Where autograd records (grad mode on, and x or a parameter requires
grad) each chunk runs as one function under non-reentrant
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
chunk scan's body: the backward keeps the states at chunk boundaries and
recomputes one chunk's steps at a time, so the bytes it saves grow with
the chunks, not the steps.  Prefill and decode never record and run the
same operations as before; :func:`chunk_checkpoint` turns the checkpoint
off (for measuring what it saves).

Each mixer's norm goes through the RMSNorm kernel (``use_kernel``); the
projections and the recurrences are plain PyTorch, as they are outside
any Pallas kernel in the reference.  The states are NamedTuples of
tensors with the batch on axis 0; the decode cache keeps their fields as
the entry's keys (``repro_torch.models.transformer``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import Params, _winit, dense, rmsnorm

NEG_INF = -1e30
D_CONV = 4        # Mamba's conv width
# leaves kept in fp32 whatever the model's param dtype (the reference's)
FP32_LEAVES = {"mamba": ("A_log", "D"), "mlstm": ("wi", "wf"),
               "slstm": ("bi", "bf", "bz", "bo")}
_CHUNK_CHECKPOINT = [True]


@contextlib.contextmanager
def chunk_checkpoint(enabled: bool) -> Iterator[None]:
    """Within the block, the mixers checkpoint their chunks iff
    ``enabled`` (default on)."""
    saved, _CHUNK_CHECKPOINT[0] = _CHUNK_CHECKPOINT[0], enabled
    try:
        yield
    finally:
        _CHUNK_CHECKPOINT[0] = saved


def _chunk_runner(x: torch.Tensor, p: Params):
    """How a mixer runs one chunk function: under a non-reentrant
    checkpoint where autograd records this call (grad mode on, x or a
    parameter requiring grad), else directly.  The chunks draw no random
    numbers: no RNG state to keep."""
    if (_CHUNK_CHECKPOINT[0] and torch.is_grad_enabled()
            and (x.requires_grad or any(t.requires_grad
                                        for t in p.values()))):
        return functools.partial(checkpoint, use_reentrant=False,
                                 preserve_rng_state=False)
    return lambda fn, *args: fn(*args)


# ==========================================================================
# Mamba (selective SSM)
# ==========================================================================

def init_mamba(gen: torch.Generator, d_model: int, d_state: int = 16,
               d_conv: int = D_CONV, expand: int = 2, dtype=torch.bfloat16,
               device=None) -> Params:
    di = expand * d_model
    dt_rank = -(-d_model // 16)
    w = lambda shape, fan_in: _winit(gen, shape, fan_in, dtype, device)
    return {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "in_proj": w((d_model, 2 * di), d_model),
        "conv_w": w((d_conv, di), d_conv),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": w((di, dt_rank + 2 * d_state), di),
        "dt_proj": w((dt_rank, di), dt_rank),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype,   # softplus^-1(0.01)
                              device=device),
        "A_log": torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=device)
        ).expand(di, d_state).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": w((di, d_model), di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over seq. x: (B,S,di), w: (K,di).

    ``hist``: (B, K-1, di) trailing context from a previous segment (decode
    continuation); zeros when starting fresh.
    """
    k, s = w.shape[0], x.shape[1]
    if hist is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([hist.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return out + b


def _mamba_ssm_params(x: torch.Tensor, p: Params, d_state: int):
    """delta (B,S,di), B/C (B,S,N) from the conv output."""
    dt_rank = p["dt_proj"].shape[0]
    dbl = dense(x, p["x_proj"])
    dt, bmat, cmat = torch.split(dbl, [dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus(dense(dt, p["dt_proj"]) + p["dt_bias"].to(x.dtype))
    return delta, bmat, cmat


def _scan(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the combine ``(a1, b1), (a2, b2) ->
    (a2 a1, a2 b1 + b2)`` (the earlier element first), by doubling: after
    the step of offset o, element t holds the combine of the 2o elements
    ending at t.  Returns (a_cum, b_cum)."""
    c, off = a.shape[1], 1
    while off < c:
        a_hi, b_hi = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_hi * b[:, :-off] + b_hi], dim=1)
        a = torch.cat([a[:, :off], a_hi * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _mamba_chunk(h0, delta, bmat, cmat, x, A):
    """One chunk of the selective scan.

    h0: (B, di, N); delta/x: (B, C, di); bmat/cmat: (B, C, N); A: (di, N).
    Returns (h_last, y (B, C, di)).
    """
    df = delta.float()
    dA = torch.exp(df[..., None] * A)                            # (B,C,di,N)
    dBx = (df * x.float())[..., None] * bmat.float()[..., None, :]
    a_cum, b_cum = _scan(dA, dBx)
    h_all = a_cum * h0[:, None] + b_cum                          # (B,C,di,N)
    y = torch.einsum("bcdn,bcn->bcd", h_all, cmat.float())
    # a copy, not a view: the next chunk keeps h, never this chunk's h_all
    return h_all[:, -1].clone(), y


class MambaState(NamedTuple):
    h: torch.Tensor       # (B, di, N) fp32
    conv: torch.Tensor    # (B, K-1, di) -- conv ring buffer


def mamba_mix(x: torch.Tensor, p: Params, chunk: int = 64,
              state: Optional[MambaState] = None
              ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence Mamba mixer. x: (B,S,D) -> (y, MambaState)."""
    b, s, _ = x.shape
    di = p["in_proj"].shape[1] // 2
    n = p["A_log"].shape[1]
    kconv = p["conv_w"].shape[0]
    x_raw, z = dense(x, p["in_proj"]).chunk(2, dim=-1)
    hist = state.conv if state is not None else None
    xs = F.silu(_causal_conv(x_raw, p["conv_w"], p["conv_b"], hist))
    # trailing conv context for decode continuation
    if s >= kconv - 1:
        conv_tail = x_raw[:, s - (kconv - 1):]
    else:
        conv_tail = torch.cat([x_raw.new_zeros((b, kconv - 1 - s, di)),
                               x_raw], dim=1)
    delta, bmat, cmat = _mamba_ssm_params(xs, p, n)
    A = -torch.exp(p["A_log"].float())

    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    # padded timesteps must be state-identity: delta=0 -> dA=1, dBx=0
    padt = (lambda t: F.pad(t, (0, 0, 0, pad))) if pad else (lambda t: t)
    delta, bmat, cmat, xs_p = (padt(t) for t in (delta, bmat, cmat, xs))
    h = (state.h if state is not None
         else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    run = _chunk_runner(x, p)
    ys = []
    for ci in range(n_chunks):
        cs = slice(ci * chunk, (ci + 1) * chunk)
        h, y = run(_mamba_chunk, h, delta[:, cs], bmat[:, cs], cmat[:, cs],
                   xs_p[:, cs], A)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y.to(x.dtype) + xs * p["D"].to(x.dtype)
    return (dense(y * F.silu(z), p["out_proj"]),
            MambaState(h, conv_tail.contiguous()))


def init_mamba_state(batch: int, d_inner: int, d_state: int, dtype,
                     device=None, d_conv: int = D_CONV) -> MambaState:
    """Zero state: h in fp32, the conv tail in ``dtype`` (the reference's
    takes these sizes from a params tree; the decode cache has none)."""
    return MambaState(
        torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                    device=device))


def mamba_decode(x: torch.Tensor, p: Params, st: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step. x: (B, 1, D)."""
    n = p["A_log"].shape[1]
    xs, z = dense(x, p["in_proj"]).chunk(2, dim=-1)         # (B,1,di)
    hist = torch.cat([st.conv, xs], dim=1)                  # (B,K,di)
    conv = torch.einsum("bkd,kd->bd", hist, p["conv_w"]) + p["conv_b"]
    xs1 = F.silu(conv)[:, None, :]
    delta, bmat, cmat = _mamba_ssm_params(xs1, p, n)
    A = -torch.exp(p["A_log"].float())
    df = delta[:, 0].float()                                # (B,di)
    dA = torch.exp(df[..., None] * A)
    dBx = (df * xs1[:, 0].float())[..., None] \
        * bmat[:, 0].float()[:, None, :]
    h = dA * st.h + dBx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float())
    y = y.to(x.dtype) + xs1[:, 0] * p["D"].to(x.dtype)
    out = dense((y * F.silu(z[:, 0]))[:, None], p["out_proj"])
    return out, MambaState(h, hist[:, 1:])


def mamba_block(x, p, cfg, state=None, decode=False, use_kernel=True):
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    if decode:
        y, new_state = mamba_decode(h, p, state)
    else:
        y, new_state = mamba_mix(h, p, cfg.ssm_chunk, state)
    return x + y, new_state


# ==========================================================================
# xLSTM -- mLSTM (matrix memory) and sLSTM (scalar memory)
# ==========================================================================

def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               dtype=torch.bfloat16, device=None) -> Params:
    w = lambda dt, cols: _winit(gen, (d_model, cols), d_model, dt, device)
    return {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "wq": w(dtype, d_model), "wk": w(dtype, d_model),
        "wv": w(dtype, d_model),
        "wi": w(torch.float32, n_heads), "wf": w(torch.float32, n_heads),
        "wz": w(dtype, d_model), "wo": w(dtype, d_model),
    }


class LstmState(NamedTuple):
    c: torch.Tensor   # mLSTM: (B,H,dk,dv); sLSTM: (B,D)
    n: torch.Tensor   # mLSTM: (B,H,dk);    sLSTM: (B,D)
    m: torch.Tensor   # stabilizer: (B,H) / (B,D)


def init_mlstm_state(batch: int, n_heads: int, dh: int,
                     device=None) -> LstmState:
    f32 = dict(dtype=torch.float32, device=device)
    return LstmState(torch.zeros((batch, n_heads, dh, dh), **f32),
                     torch.zeros((batch, n_heads, dh), **f32),
                     torch.full((batch, n_heads), NEG_INF, **f32))


def _mlstm_step(st: LstmState, q, k, v, i_pre, f_pre):
    """One mLSTM cell step. q/k/v: (B,H,dh); i/f pre-activations: (B,H)."""
    dh = q.shape[-1]
    f_log = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_log + st.m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_log + st.m - m_new)
    kf = k.float() / math.sqrt(dh)
    c = (f_g[..., None, None] * st.c
         + i_g[..., None, None] * (v.float()[..., None, :]
                                   * kf[..., :, None]))
    n = f_g[..., None] * st.n + i_g[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhkv,bhk->bhv", c, qf)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, qf).abs(), min=1.0)
    h = num / den[..., None]
    return LstmState(c, n, m_new), h


def _mlstm_chunk(c, n, m, q, k, v, i_pre, f_pre):
    """The steps of one chunk from the state (c, n, m); q/k/v (B,C,H,dh),
    i/f (B,C,H).  Returns (c, n, m, h (B,C,H,dh))."""
    st, hs = LstmState(c, n, m), []
    for t in range(q.shape[1]):
        st, h = _mlstm_step(st, q[:, t], k[:, t], v[:, t], i_pre[:, t],
                            f_pre[:, t])
        hs.append(h)
    return (*st, torch.stack(hs, dim=1))


def _chunks(s: int, chunk: int) -> Tuple[int, int]:
    """(chunk, padded steps) the reference runs for s tokens: whole chunks
    of ``min(chunk, s)``."""
    chunk = min(chunk, s)
    return chunk, -(-s // chunk) * chunk


def mlstm_mix(x: torch.Tensor, p: Params, n_heads: int, chunk: int = 64,
              state: Optional[LstmState] = None
              ) -> Tuple[torch.Tensor, LstmState]:
    b, s, d = x.shape
    dh = d // n_heads
    # fp32 copies made once for the whole sequence (the step casts each
    # token's slice to fp32: the same values)
    q, k, v = (dense(x, p[w]).reshape(b, s, n_heads, dh).float()
               for w in ("wq", "wk", "wv"))
    i_pre = torch.einsum("bsd,dh->bsh", x.float(), p["wi"].float())
    f_pre = torch.einsum("bsd,dh->bsh", x.float(), p["wf"].float())
    z = dense(x, p["wz"])

    chunk, steps = _chunks(s, chunk)
    pad = steps - s
    if pad:
        # state-identity padding: i-gate -> -inf (no write), f-gate -> keep
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG_INF)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    st = (state if state is not None
          else init_mlstm_state(b, n_heads, dh, device=x.device))
    run = _chunk_runner(x, p)
    hs = []
    for t0 in range(0, steps, chunk):
        cs = slice(t0, t0 + chunk)
        *st, h = run(_mlstm_chunk, *st, q[:, cs], k[:, cs], v[:, cs],
                     i_pre[:, cs], f_pre[:, cs])
        hs.append(h)
    st = LstmState(*st)
    h = torch.cat(hs, dim=1)[:, :s].reshape(b, s, d)
    out = dense(h.to(x.dtype) * F.silu(z), p["wo"])
    return out, st


def init_slstm(gen: torch.Generator, d_model: int, n_heads: int,
               dtype=torch.bfloat16, device=None) -> Params:
    dh = d_model // n_heads
    p = {"ln": torch.ones((d_model,), dtype=dtype, device=device)}
    for g in "ifzo":
        p[f"w{g}"] = _winit(gen, (d_model, d_model), d_model, dtype, device)
    for g in "ifzo":
        p[f"r{g}"] = _winit(gen, (n_heads, dh, dh), dh, dtype, device)
    for g in "ifzo":
        p[f"b{g}"] = torch.zeros((d_model,), dtype=torch.float32,
                                 device=device)
    p["wo_out"] = _winit(gen, (d_model, d_model), d_model, dtype, device)
    return p


class SlstmState(NamedTuple):
    c: torch.Tensor   # (B, D)
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D)
    h: torch.Tensor   # (B, D) -- recurrent hidden input to the gates


def init_slstm_state(batch: int, d_model: int, device=None) -> SlstmState:
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return SlstmState(z, z + 1e-6, z + NEG_INF, z.clone())


def _slstm_step(p: Params, n_heads: int, st: SlstmState, x_t):
    """x_t: dict of (B,D) pre-projected gate inputs (+ optional 'v' valid
    flag (B,1) -- invalid (padded) steps leave the state untouched)."""
    b, d = st.h.shape
    dh = d // n_heads
    hh = st.h.reshape(b, n_heads, dh)

    def gate(g):
        rec = torch.einsum("bhk,hkv->bhv", hh.float(),
                           p[f"r{g}"].float()).reshape(b, d)
        return x_t[g] + rec + p[f"b{g}"]

    i_pre, f_pre, z_pre, o_pre = (gate(g) for g in "ifzo")
    f_log = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_log + st.m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_log + st.m - m_new)
    z_t = torch.tanh(z_pre)
    c = f_g * st.c + i_g * z_t
    n = f_g * st.n + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    new = SlstmState(c, n, m_new, h)
    if "v" in x_t:
        v = x_t["v"]
        new = SlstmState(*(v * a + (1.0 - v) * b_
                           for a, b_ in zip(new, st)))
    return new, h


def _slstm_chunk(p: Params, n_heads: int, c, n, m, h, *gates):
    """The steps of one chunk from the state (c, n, m, h); ``gates`` the
    chunk's i, f, z, o inputs (B,C,D) and valid flag (B,C,1).  Returns
    (c, n, m, h, h of every step (B,C,D))."""
    st, hs = SlstmState(c, n, m, h), []
    for t in range(gates[0].shape[1]):
        st, h = _slstm_step(p, n_heads, st,
                            {g: x[:, t] for g, x in zip("ifzov", gates)})
        hs.append(h)
    return (*st, torch.stack(hs, dim=1))


def slstm_mix(x: torch.Tensor, p: Params, n_heads: int, chunk: int = 64,
              state: Optional[SlstmState] = None
              ) -> Tuple[torch.Tensor, SlstmState]:
    b, s, d = x.shape
    xg = {g: torch.einsum("bsd,df->bsf", x, p[f"w{g}"]).float()
          for g in "ifzo"}
    xg["v"] = torch.ones((b, s, 1), dtype=torch.float32, device=x.device)
    chunk, steps = _chunks(s, chunk)
    pad = steps - s
    if pad:
        xg = {g: F.pad(t, (0, 0, 0, pad)) for g, t in xg.items()}
    # the recurrent weights in fp32 once (the step casts them: the same
    # values)
    pf = dict(p, **{f"r{g}": p[f"r{g}"].float() for g in "ifzo"})
    st = (state if state is not None
          else init_slstm_state(b, d, device=x.device))
    run, body = _chunk_runner(x, p), functools.partial(_slstm_chunk, pf,
                                                       n_heads)
    hs = []
    for t0 in range(0, steps, chunk):
        *st, h = run(body, *st, *(xg[g][:, t0:t0 + chunk] for g in "ifzov"))
        hs.append(h)
    st = SlstmState(*st)
    h = torch.cat(hs, dim=1)[:, :s]
    return dense(h.to(x.dtype), p["wo_out"]), st


def mlstm_block(x, p, cfg, state=None, decode=False, use_kernel=True):
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    if decode:
        b = x.shape[0]
        dh = cfg.d_model // cfg.n_heads
        q, k, v = (dense(h[:, 0], p[w]).reshape(b, cfg.n_heads, dh)
                   for w in ("wq", "wk", "wv"))
        i_pre = h[:, 0].float() @ p["wi"].float()
        f_pre = h[:, 0].float() @ p["wf"].float()
        z = dense(h[:, 0], p["wz"])
        st, hh = _mlstm_step(state, q, k, v, i_pre, f_pre)
        hh = hh.reshape(b, cfg.d_model)
        out = dense((hh.to(x.dtype) * F.silu(z))[:, None], p["wo"])
        return x + out, st
    y, st = mlstm_mix(h, p, cfg.n_heads, cfg.ssm_chunk, state)
    return x + y, st


def slstm_block(x, p, cfg, state=None, decode=False, use_kernel=True):
    h = rmsnorm(x, p["ln"], use_kernel=use_kernel)
    if decode:
        xt = {g: (h[:, 0] @ p[f"w{g}"]).float() for g in "ifzo"}
        st, hh = _slstm_step(p, cfg.n_heads, state, xt)
        out = dense(hh.to(x.dtype)[:, None], p["wo_out"])
        return x + out, st
    y, st = slstm_mix(h, p, cfg.n_heads, cfg.ssm_chunk, state)
    return x + y, st
