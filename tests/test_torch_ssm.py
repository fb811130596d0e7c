"""Port parity for the recurrent mixers (``repro_torch.models.ssm``)
against ``repro.models.ssm`` on numpy-seeded inputs, fp32: Mamba's causal
conv with and without a history, its chunked scan (the doubling scan
against a step loop), ``mamba_mix`` with S not a multiple of the chunk and
with an initial state, and a prefill continued by decode steps, which must
equal the mix over the longer sequence; mLSTM and sLSTM the same.

Tolerance: 1e-5 of max |ref| (fp32; sums and the scan's products in other
orders).  The stepwise mLSTM/sLSTM prefill and the one-step decode compute
the same cell with the same operations, so decode after a prefill agrees
with the longer mix as closely.

The chunk checkpoint: each mixer's gradients (input and every parameter)
against ``jax.grad`` of the reference's (its scan body under
``jax.checkpoint``) at 1e-4 of max |ref| (fp32; the backward sums in
other orders); outputs and gradients bit-equal with the checkpoint on and
off; and the bytes a backward saves (the storages packed by
``saved_tensors_hooks``, each once) grow by the states at the chunk
boundaries a chunk, not by a state a step."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.models import ssm as JS
from repro_torch.models import ssm as TS

TOL = 1e-5        # x max |ref|, fp32
D, H, N, CHUNK = 16, 2, 4, 8


class _Cfg:
    """The fields the blocks read."""
    d_model, n_heads, ssm_chunk = D, H, CHUNK


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(init, *args):
    jp = init(jax.random.PRNGKey(7), D, *args, dtype=jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.fixture(scope="module")
def mamba():
    jp, tp = _params(JS.init_mamba, N)
    # a dt_bias near 0, so delta ~ 0.7 and the state moves a lot per step
    jp["dt_bias"] = jnp.zeros_like(jp["dt_bias"])
    tp["dt_bias"] = torch.zeros_like(tp["dt_bias"])
    return jp, tp


@pytest.fixture(scope="module")
def mlstm():
    return _params(JS.init_mlstm, H)


@pytest.fixture(scope="module")
def slstm():
    return _params(JS.init_slstm, H)


def _states_close(got, want, tol=TOL):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w[np.abs(w) < 1e29]).max(initial=0.0)),
                    1e-30)
        assert float(np.abs(g.float().numpy() - w).max()) <= tol * scale, \
            name


# -------------------------------------------------------------------- Mamba

@pytest.mark.parametrize("with_hist", [False, True],
                         ids=["fresh", "with_hist"])
def test_causal_conv(mamba, with_hist):
    jp, tp = mamba
    x = _x((2, 11, 2 * D), 0)
    hist = _x((2, 3, 2 * D), 1) if with_hist else None
    want = JS._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                           None if hist is None else jnp.asarray(hist))
    got = TS._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
                          None if hist is None else torch.from_numpy(hist))
    assert _rel(got, want) <= TOL


def test_doubling_scan_equals_step_loop():
    """The chunk's scan over 64 steps with A < 0 (dA far below 1: its
    running product underflows) against the recurrence stepped in
    order."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(np.exp(-rng.uniform(0.5, 4.0, (2, 64, 3, 5)))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 64, 3, 5))
                         .astype(np.float32))
    a_cum, b_cum = TS._scan(a, b)
    h, pa = torch.zeros(2, 3, 5), torch.ones(2, 3, 5)
    for t in range(64):
        h, pa = a[:, t] * h + b[:, t], a[:, t] * pa
        assert torch.allclose(b_cum[:, t], h, rtol=1e-6, atol=1e-6), t
        # (fp32's subnormals, below 1.2e-38, keep fewer digits)
        assert torch.allclose(a_cum[:, t], pa, rtol=1e-5, atol=1e-37), t
    assert float(a_cum[:, -1].min()) == 0.0      # underflowed, no NaN


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "with_state"])
def test_mamba_mix_matches_reference(mamba, with_state):
    """S = 19 over chunks of 8 (the last padded by 5 state-identity
    steps), fresh or continuing a state."""
    jp, tp = mamba
    x = _x((2, 19, D), 3)
    jst = tst = None
    if with_state:
        h0, c0 = _x((2, 2 * D, N), 4), _x((2, 3, 2 * D), 5)
        jst = JS.MambaState(jnp.asarray(h0), jnp.asarray(c0))
        tst = TS.MambaState(torch.from_numpy(h0), torch.from_numpy(c0))
    jy, jnew = JS.mamba_mix(jnp.asarray(x), jp, CHUNK, jst)
    ty, tnew = TS.mamba_mix(torch.from_numpy(x), tp, CHUNK, tst)
    assert _rel(ty, jy) <= TOL
    _states_close(tnew, jnew)


@pytest.mark.parametrize("s0", [2, 13], ids=["short_prompt", "prompt_13"])
def test_mamba_prefill_then_decode_equals_longer_mix(mamba, s0):
    """A prefill of s0 tokens (2: shorter than the conv's tail, which is
    then zero-filled), then decode steps to 19: each step's output equals
    the mix over all 19 tokens at that position, and each step equals the
    reference's decode from the same state."""
    jp, tp = mamba
    x = _x((2, 19, D), 6)
    full, _ = TS.mamba_mix(torch.from_numpy(x), tp, CHUNK)
    _, st = TS.mamba_mix(torch.from_numpy(x[:, :s0]), tp, CHUNK)
    _, jst = JS.mamba_mix(jnp.asarray(x[:, :s0]), jp, CHUNK)
    _states_close(st, jst)
    for t in range(s0, 19):
        xt = x[:, t:t + 1]
        y, st = TS.mamba_decode(torch.from_numpy(xt), tp, st)
        jy, jst = JS.mamba_decode(jnp.asarray(xt), jp, jst)
        assert _rel(y, jy) <= TOL
        assert _rel(y, full[:, t:t + 1].numpy()) <= TOL
    _states_close(st, jst)


# ------------------------------------------------------------ mLSTM, sLSTM

_MIX = {"mlstm": (JS.mlstm_mix, TS.mlstm_mix),
        "slstm": (JS.slstm_mix, TS.slstm_mix)}


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "with_state"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lstm_mix_matches_reference(kind, with_state, mlstm, slstm):
    """S = 19 over chunks of 8: the last chunk padded with i = -1e30,
    f = 30 (mLSTM) or the sLSTM's valid flag 0, so the final state is the
    reference's; fresh, or continuing the state 5 tokens leave."""
    jp, tp = {"mlstm": mlstm, "slstm": slstm}[kind]
    jmix, tmix = _MIX[kind]
    x = _x((2, 19, D), 8)
    jst = tst = None
    if with_state:
        x0 = _x((2, 5, D), 9)
        _, jst = jmix(jnp.asarray(x0), jp, H, CHUNK)
        _, tst = tmix(torch.from_numpy(x0), tp, H, CHUNK)
        _states_close(tst, jst)
    jy, jnew = jmix(jnp.asarray(x), jp, H, CHUNK, jst)
    ty, tnew = tmix(torch.from_numpy(x), tp, H, CHUNK, tst)
    assert _rel(ty, jy) <= TOL
    _states_close(tnew, jnew)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lstm_prefill_then_decode_equals_longer_mix(kind, mlstm, slstm):
    """The blocks (norm included): a prefill of 11 tokens (a padded
    chunk), then decode steps to 19 equal the prefill over all 19 at each
    position, and the reference's decode step by step."""
    jp, tp = {"mlstm": mlstm, "slstm": slstm}[kind]
    jblock = {"mlstm": JS.mlstm_block, "slstm": JS.slstm_block}[kind]
    tblock = {"mlstm": TS.mlstm_block, "slstm": TS.slstm_block}[kind]
    x = _x((2, 19, D), 10)
    full, _ = tblock(torch.from_numpy(x), tp, _Cfg)
    _, st = tblock(torch.from_numpy(x[:, :11]), tp, _Cfg)
    _, jst = jblock(jnp.asarray(x[:, :11]), jp, _Cfg)
    for t in range(11, 19):
        xt = x[:, t:t + 1]
        y, st = tblock(torch.from_numpy(xt), tp, _Cfg, st, decode=True)
        jy, jst = jblock(jnp.asarray(xt), jp, _Cfg, jst, decode=True)
        assert _rel(y, jy) <= TOL
        assert _rel(y, full[:, t:t + 1].numpy()) <= TOL
    _states_close(st, jst)


def test_initial_states(mamba):
    jp, _ = mamba
    m = TS.init_mlstm_state(2, H, D // H)
    s = TS.init_slstm_state(2, D)
    z = TS.init_mamba_state(2, 2 * D, N, torch.float32)
    jm = JS.init_mlstm_state(2, H, D // H)
    js = JS.init_slstm_state(2, D)
    jz = JS.init_mamba_state(2, jp)
    for got, want in ((m, jm), (s, js), (z, jz)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------- chunk checkpoint

GRAD_TOL = 1e-4   # x max |ref grad|, fp32
_MIXERS = ("mamba", "mlstm", "slstm")


def _mix_fns(kind):
    """(reference mix, port mix), each f(x, params, chunk) -> y."""
    if kind == "mamba":
        return (lambda x, p, c: JS.mamba_mix(x, p, c)[0],
                lambda x, p, c: TS.mamba_mix(x, p, c)[0])
    jmix, tmix = _MIX[kind]
    return (lambda x, p, c: jmix(x, p, H, c)[0],
            lambda x, p, c: tmix(x, p, H, c)[0])


def _port_value_and_grads(kind, tp, x, chunk, cot):
    """The port's output and (dx, {name: dparam}) of <y, cot>."""
    _, tmix = _mix_fns(kind)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmix(xt, p, chunk)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                [xt, *p.values()], allow_unused=True)
    # the block's norm weight is not the mix's: its gradient is zero
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip([xt, *p.values()], grads)]
    return y.detach(), grads[0], dict(zip(p, grads[1:]))


@pytest.mark.parametrize("kind", _MIXERS)
def test_mix_gradients_match_reference(kind, mamba, mlstm, slstm):
    """S = 19 over chunks of 8 (3 chunks, the last padded): the gradients
    of <mix(x), cot> with respect to x and every parameter against
    ``jax.grad`` of the reference's mix."""
    jp, tp = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}[kind]
    jmix, _ = _mix_fns(kind)
    x, cot = _x((2, 19, D), 11), _x((2, 19, D), 12)
    jdx, jdp = jax.grad(
        lambda xx, pp: jnp.sum(jmix(xx, pp, CHUNK) * cot), argnums=(0, 1))(
            jnp.asarray(x), jp)
    _, dx, dp = _port_value_and_grads(kind, tp, x, CHUNK, cot)
    assert _rel(dx, jdx) <= GRAD_TOL
    # a leaf whose exact gradient is 0 (the block's norm weight; sLSTM's
    # i-gate bias, whose first step cancels in i - m) gets rounding noise
    # in both packages: it is held below 1e-6 of the largest gradient
    noise = 1e-6 * max(float(np.abs(np.asarray(g)).max())
                       for g in jdp.values())
    for name, g in dp.items():
        want = np.asarray(jdp[name])
        if float(np.abs(want).max()) <= noise:
            assert float(g.abs().max()) <= noise, name
            continue
        assert _rel(g, want) <= GRAD_TOL, name


@pytest.mark.parametrize("kind", _MIXERS)
def test_chunk_checkpoint_keeps_values_bit_equal(kind, mamba, mlstm, slstm):
    """The checkpointed backward recomputes each chunk with the same
    operations: outputs and every gradient are bit-equal to autograd
    through the chunks without it."""
    _, tp = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}[kind]
    x, cot = _x((2, 19, D), 13), _x((2, 19, D), 14)
    y1, dx1, dp1 = _port_value_and_grads(kind, tp, x, CHUNK, cot)
    with TS.chunk_checkpoint(False):
        y0, dx0, dp0 = _port_value_and_grads(kind, tp, x, CHUNK, cot)
    assert torch.equal(y1, y0) and torch.equal(dx1, dx0)
    for name in dp0:
        assert torch.equal(dp1[name], dp0[name]), name


def _saved_bytes(kind, tp, s, chunk, enabled=True) -> int:
    """Bytes of the distinct storages autograd saves for a backward
    through the mix of a (1, s, D) input in chunks of ``chunk``."""
    _, tmix = _mix_fns(kind)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    x = torch.from_numpy(_x((1, s, D), 15)).requires_grad_(True)
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t

    with TS.chunk_checkpoint(enabled), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tmix(x, p, chunk)
    return sum(storages.values())


def _state_bytes(kind) -> int:
    st = {"mamba": lambda: TS.init_mamba_state(1, 2 * D, N, torch.float32),
          "mlstm": lambda: TS.init_mlstm_state(1, H, D // H),
          "slstm": lambda: TS.init_slstm_state(1, D)}[kind]()
    # Mamba's conv tail is not carried between chunks
    fields = st[:1] if kind == "mamba" else st
    return sum(t.nbytes for t in fields)


@pytest.mark.parametrize("kind", _MIXERS)
def test_backward_saves_bytes_by_chunk_not_by_step(kind, mamba, mlstm,
                                                   slstm):
    """At 2 chunks, S 8 -> 32 (24 more steps): the checkpointed mix saves
    at least a state a step less than the mix without the checkpoint (its
    growth is the sequence's projections).  At S 32, chunks 2 -> 4 -> 8:
    each added chunk saves exactly one more state (its boundary state).
    (Mamba's chunk returns a copy of its last state: a view of the chunk's
    (B, C, di, N) states would keep all of them.)"""
    _, tp = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}[kind]
    state = _state_bytes(kind)
    grow_on = _saved_bytes(kind, tp, 32, 16) - _saved_bytes(kind, tp, 8, 4)
    grow_off = (_saved_bytes(kind, tp, 32, 16, enabled=False)
                - _saved_bytes(kind, tp, 8, 4, enabled=False))
    assert grow_off - grow_on >= 24 * state, (grow_on, grow_off, state)
    by_chunks = [_saved_bytes(kind, tp, 32, c) for c in (16, 8, 4)]
    per_chunk = [(by_chunks[1] - by_chunks[0]) / 2,
                 (by_chunks[2] - by_chunks[1]) / 4]
    assert per_chunk == [state, state], (per_chunk, state)
