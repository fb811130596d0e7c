"""Port parity for the LM training path, against the reference on the same
seeded numpy inputs: chunked attention's forward and custom backward
(``jax.vjp``), ``loss_fn`` and every gradient leaf (``jax.grad``), the
masked ``chunked_xent``, ``cosine_schedule``, Adam on identical gradients,
one ``train_step_fn`` step with and without gradient accumulation (the
reference's step, unjitted), the embedding's NaN fill (``jnp.take``), the
RMSNorm Function's backward, the training forward's norm count under
remat (an encoder-decoder's too), the synthetic data, and the
forward-only kernels' refusal of autograd inputs."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adam as JA
from repro.train import steps as JS
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TD
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import gemm as TG
from repro_torch.kernels import rmsnorm as TR
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adam as TA
from repro_torch.train import steps as TS
from repro_torch.train.checkpoint import flatten

ATTN_TOL = 1e-5       # x max |ref|, fp32: two fp32 sums in other orders
LOSS_RTOL = 1e-5      # fp32 loss, relative
GRAD_TOL = 1e-4       # x max |g| of each leaf, fp32
# one train step's parameters, fp32 (lr 5e-4).  Adam's first step moves
# an element by lr * g / (|g| + eps): about lr wherever |g| >> eps, but an
# element whose gradient is near eps, where the two packages' sums in other
# orders disagree in the leading digits, lands elsewhere.  Measured on an
# x86-64 CPU: 10 of 139,840 elements beyond 1e-7, the largest 5.5e-6 =
# 0.011 lr.
STEP_ABS_TOL = 0.05   # x lr, every element
STEP_OUTLIERS = 1e-4  # share of elements allowed beyond 1e-6 absolute


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.detach().float().numpy() - want).max()) / scale


def _rng_normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------- attention

ATTN_CASES = {   # b, sq, sk, hq, hkv, d, causal, window, chunk, q_offset
    "causal": (2, 24, 24, 4, 4, 8, True, None, 8, 0),
    "window": (1, 20, 20, 2, 2, 8, True, 6, 8, 0),
    "gqa_ragged_sk": (2, 21, 21, 6, 2, 16, True, None, 8, 0),
    "non_causal_cross": (1, 9, 13, 4, 2, 8, False, None, 4, 0),
    "q_offset": (1, 7, 19, 4, 1, 8, True, None, 8, 12),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_forward_and_vjp_match_reference(case):
    """Forward and the custom backward against ``jax.vjp`` of the
    reference's ``chunked_attention``: causal, a sliding window, GQA with
    Sk not a multiple of the chunk, non-causal attention over a longer Sk,
    and a prefill continuation (``q_offset``)."""
    b, sq, sk, hq, hkv, d, causal, window, chunk, off = ATTN_CASES[case]
    q = _rng_normal(0, (b, sq, hq, d))
    k = _rng_normal(1, (b, sk, hkv, d))
    v = _rng_normal(2, (b, sk, hkv, d))
    g = _rng_normal(3, (b, sq, hq, d))
    fn = lambda q, k, v: JL.chunked_attention(q, k, v, causal, window,
                                              chunk, off)
    jout, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tout = TL.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                chunk=chunk, q_offset=off)
    assert tout.grad_fn is not None
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    assert _rel(tout, jout) <= ATTN_TOL
    for name, got, want in zip("qkv", tgrads, jgrads):
        assert _rel(got, want) <= ATTN_TOL, name
    with torch.no_grad():     # the forward alone: the same numbers
        again = TL.chunked_attention(tq, tk, tv, causal=causal,
                                     window=window, chunk=chunk, q_offset=off)
    assert torch.equal(again, tout.detach())


# ------------------------------------------------------------ loss and grads

@functools.lru_cache(maxsize=None)
def _jax_model(arch, dtype):
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    jc = jax_get_config(arch, reduced=True).with_(dtype=jd, param_dtype=jd)
    return jc, JT.init_params(jax.random.PRNGKey(0), jc)


def _models(arch, dtype="fp32"):
    """The reference's config and seeded weights (made once per module),
    and the port's config with a fresh copy of the same weights."""
    jc, jp = _jax_model(arch, dtype)
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    tc = get_config(arch, reduced=True).with_(dtype=td, param_dtype=td)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _jax_value_and_grad(jc, batch):
    """``jax.value_and_grad(T.loss_fn)`` at ``batch``, jitted (the same
    function; a jitted call costs a fraction of an eager one here)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jc),
                                      has_aux=True))


def _lm_batch(vocab, b, s, seed, masked=0, cfg=None):
    """Tokens and next-token labels (the first ``masked`` masked); with a
    ``cfg`` that has them, the stub frontends' patches (B, P, D) or frames
    (B, F, D), standard normal fp32, as the reference's
    tests/test_models.py feeds them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    if masked:
        labels[:, :masked] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg is not None and cfg.vision_prefix:
        batch["patches"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg is not None and cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _grads_close(tc, tgrads, jgrads, tol):
    mapped = TT.params_from_jax(jax.tree.map(np.asarray, jgrads), tc,
                                device="cpu")
    want = dict(flatten(mapped))
    got = dict(zip([k for k, _ in flatten(mapped)], tgrads))
    worst = max(_rel(got[k], want[k].float().numpy()) for k in want)
    assert worst <= tol, worst
    return worst


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-360m",
                                  "whisper-base", "internvl2-26b"])
def test_loss_and_every_gradient_match_reference(arch):
    """``loss_fn`` (training forward: chunked attention with its backward,
    the RMSNorm Function, remat, chunked xent over 2 chunks) and every
    gradient leaf against ``jax.grad(T.loss_fn)``, fp32.  whisper: the
    encoder over 32 drawn frames, ``enc_ln`` and the cross parts get
    their gradients through the cross attention's keys and values;
    internvl2: 8 drawn patches ahead of the tokens, whose positions the
    loss masks (the token count is the text's)."""
    jc, tc, jp, tp = _models(arch)
    batch = _lm_batch(jc.vocab, 2, 48, seed=5, masked=3, cfg=jc)
    (jloss, jm), jgrads = _jax_value_and_grad(jc, batch)(jp)
    leaves = TS.trainable(tp)
    tloss, tm = TT.loss_fn(tp, TS.to_device(batch, "cpu"), tc)
    tgrads = torch.autograd.grad(tloss, leaves)
    tloss = tloss.detach()
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 48 - 2 - 2 * 3
    _grads_close(tc, tgrads, jgrads, GRAD_TOL)


def test_bf16_loss_and_gradients_within_held_divergence():
    """bf16 weights and activations on reduced qwen2-1.5b.  The port's
    norms compute in fp32 and round once (the RMSNorm kernel's function and
    its fp32 backward), the reference's jnp norm rounds rsqrt to bf16 and
    multiplies in bf16; projections round at places XLA and PyTorch choose
    differently.  Measured on an x86-64 CPU (PyTorch 2.13, jax 0.9): the
    loss within 1.33e-5 relative, each gradient leaf within 3.42e-2 of its
    max |g|; held to 1e-3 and 1e-1 (a few bf16 steps of 2^-8 through 2
    layers and the backward)."""
    jc, tc, jp, tp = _models("qwen2-1.5b", "bf16")
    batch = _lm_batch(jc.vocab, 2, 48, seed=6)
    (jloss, _), jgrads = _jax_value_and_grad(jc, batch)(jp)
    leaves = TS.trainable(tp)
    tloss, _ = TT.loss_fn(tp, TS.to_device(batch, "cpu"), tc)
    tgrads = torch.autograd.grad(tloss, leaves)
    tloss = tloss.detach()
    assert all(g.dtype == torch.bfloat16 for g in tgrads)
    assert abs(float(tloss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    _grads_close(tc, tgrads, jgrads, 1e-1)


def test_chunked_xent_masks_labels():
    """Masked labels (< 0) add nothing; S not a multiple of the chunk (the
    reference pads its last chunk, the port's is short)."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 13, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 13)).astype(np.int32)
    labels[0, ::3] = -1
    labels[1, -4:] = -1
    jn, jc = JT.chunked_xent(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(labels), 5)
    tn, tc = TT.chunked_xent(torch.from_numpy(h), torch.from_numpy(w),
                             torch.from_numpy(labels), 5)
    assert float(tc) == float(jc) == float((labels >= 0).sum())
    assert abs(float(tn) - float(jn)) <= 1e-5 * abs(float(jn))


def _count_norms(monkeypatch):
    """(the RMSNorm Function's forward calls, its ``apply`` calls): both
    lists grow by one a norm of the training forward."""
    calls = []
    real = TR._forward
    monkeypatch.setattr(TR, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    fn_calls = []
    real_apply = TR._RMSNormFunction.apply
    monkeypatch.setattr(TR._RMSNormFunction, "apply",
                        lambda *a: fn_calls.append(1) or real_apply(*a))
    return calls, fn_calls


def test_training_forward_norm_count_under_remat(monkeypatch):
    """Every norm of the training forward goes through the RMSNorm
    Function (the kernel's launch on the card), 2 a layer + the final one,
    and remat recomputes the layers' 2 a layer in the backward: the
    identity the card's training phase holds at every step."""
    calls, fn_calls = _count_norms(monkeypatch)
    for remat, want in ((True, 4 * 2 + 1), (False, 2 * 2 + 1)):
        cfg = get_config("qwen2-1.5b", reduced=True).with_(remat=remat)
        params = TT.init_params(0, cfg, device="cpu")
        leaves = TS.trainable(params)
        calls.clear()
        fn_calls.clear()
        loss, _ = TT.loss_fn(params, TS.to_device(
            _lm_batch(cfg.vocab, 2, 16, seed=8), "cpu"), cfg)
        torch.autograd.grad(loss, leaves)
        assert len(calls) == len(fn_calls) == want, (remat, len(calls))


def test_encoder_decoder_norm_count_under_remat(monkeypatch):
    """whisper's training forward: 2 norms an encoder layer, ``enc_ln``,
    3 a decoder layer (mixer, cross, FFN) and the final one; remat
    recomputes every block's norms but ``enc_ln`` and the final one (the
    card's ``[train audio]`` holds 32 + 30 at full depth)."""
    calls, fn_calls = _count_norms(monkeypatch)
    cfg0 = get_config("whisper-base", reduced=True)
    enc, dec = cfg0.n_enc_layers, cfg0.n_layers
    fwd = 2 * enc + 1 + 3 * dec + 1
    for remat, want in ((True, fwd + 2 * enc + 3 * dec), (False, fwd)):
        cfg = cfg0.with_(remat=remat)
        params = TT.init_params(0, cfg, device="cpu")
        leaves = TS.trainable(params)
        calls.clear()
        fn_calls.clear()
        loss, _ = TT.loss_fn(params, TS.to_device(
            _lm_batch(cfg.vocab, 2, 16, seed=8, cfg=cfg), "cpu"), cfg)
        torch.autograd.grad(loss, leaves)
        assert len(calls) == len(fn_calls) == want, (remat, len(calls))


# ----------------------------------------------------------------- optimizer

def test_cosine_schedule_matches_reference_at_every_step():
    """fp32 at every step of three schedules, within 2^-21 relative (4
    fp32 ulps): XLA's and PyTorch's fp32 cos differ in the last bits
    (measured up to 2.4e-7 relative, 2 ulps); warmup steps are exact."""
    for base, warm, total in ((3e-4, 4, 20), (1e-3, 5, 60), (5e-4, 0, 7)):
        jf = JA.cosine_schedule(base, warm, total)
        tf = TA.cosine_schedule(base, warm, total)
        for step in range(total + 3):
            want = np.float32(jf(jnp.asarray(step, jnp.int32)))
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            tol = 0.0 if step < warm else 2.0 ** -21 * abs(float(want))
            assert abs(float(got) - float(want)) <= tol, (base, warm, total,
                                                          step)


def _ulps_bf16(got: torch.Tensor, want: np.ndarray) -> float:
    """Largest difference in units of the bf16 spacing at |want|."""
    want = np.asarray(want, np.float32)
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
    return float((np.abs(got.float().numpy() - want) / spacing).max())


@pytest.mark.parametrize("dtype,moment", [("fp32", None), ("bf16", None),
                                          ("bf16", "fp32"),
                                          ("fp32", "bf16")])
@pytest.mark.parametrize("wd,clip", [(0.0, None), (0.01, 1.0)])
def test_adam_matches_reference_on_identical_grads(dtype, moment, wd, clip):
    """Three updates from the same parameters and gradients: fp32 within
    1e-6 relative; where bf16 is involved (parameters or moments) within
    one bf16 spacing (each package rounds the same ops to bf16; the
    spacing of a value near a power of two differs by one)."""
    jd = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}
    sched = (3e-3, 1, 10)
    jopt = JA.Adam(lr=JA.cosine_schedule(*sched), weight_decay=wd,
                   grad_clip_norm=clip,
                   moment_dtype=None if moment is None else jd[moment])
    shapes = [(5, 7), (11,), (3, 2, 4)]
    ps = [_rng_normal(10 + i, s) for i, s in enumerate(shapes)]
    jp = [jnp.asarray(p).astype(jd[dtype]) for p in ps]
    tp = [torch.from_numpy(np.array(p.astype(jnp.float32))).to(td[dtype])
          for p in jp]
    topt = TA.Adam(tp, lr=TA.cosine_schedule(*sched), weight_decay=wd,
                   grad_clip_norm=clip,
                   moment_dtype=None if moment is None else td[moment])
    state = jopt.init(jp)
    for it in range(3):
        gs = [_rng_normal(20 + 3 * it + i, s) * 3 for i, s in
              enumerate(shapes)]
        jg = [jnp.asarray(g).astype(jd[dtype]) for g in gs]
        tg = [torch.from_numpy(np.array(g.astype(jnp.float32))).to(
            td[dtype]) for g in jg]
        jp, state = jopt.update(jg, state, jp)
        topt.step(tg)
    for got, want, m_got, m_want in zip(tp, jp, topt.mu, state.mu):
        assert got.dtype == td[dtype] and m_got.dtype == (
            td[moment] if moment else td[dtype])
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "fp32" and moment is None:
            assert _rel(got, want) <= 1e-6
            assert _rel(m_got, m_want.astype(jnp.float32)) <= 1e-6
        else:
            assert _ulps_bf16(got, want) <= 1.0
            assert _ulps_bf16(m_got, m_want.astype(jnp.float32)) <= 1.0


def test_adam_state_dict_roundtrip():
    p = [torch.ones(3), torch.zeros(2, 2)]
    opt = TA.Adam(p, lr=0.1, moment_dtype=torch.bfloat16)
    opt.step([torch.ones(3), torch.ones(2, 2)])
    state = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
             for k, v in opt.state_dict().items()}
    other = TA.Adam([torch.ones(3), torch.zeros(2, 2)], lr=0.1,
                    moment_dtype=torch.bfloat16)
    other.load_state_dict(state)
    assert other.step_count == 1
    for a, b in zip(other.mu + other.nu, opt.mu + opt.nu):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    with pytest.raises(ValueError):
        other.load_state_dict(dict(state, mu=state["mu"][:1]))


# ---------------------------------------------------------------- train step

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    """One ``train_step_fn`` step (loss, backward, clip, cosine-scheduled
    Adam with weight decay) on reduced qwen2-1.5b, fp32, against the
    reference's unjitted step: loss and grad_norm within 1e-5 relative,
    the parameters within STEP_ABS_TOL and STEP_OUTLIERS."""
    jc, tc, jp, tp = _models("qwen2-1.5b")
    ttc = TS.TrainConfig(lr=5e-4, warmup_steps=1, total_steps=10,
                         grad_accum=grad_accum)
    jtc = JS.TrainConfig(lr=5e-4, warmup_steps=1, total_steps=10,
                         grad_accum=grad_accum)
    batch = _lm_batch(jc.vocab, 4, 32, seed=9)
    jstate = JS.make_optimizer(jtc).init(jp)
    jp2, _, jm = JS.train_step_fn(jc, jtc)(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = TS.make_optimizer(ttc, tp)
    tm = TS.train_step_fn(tc, ttc)(tp, opt, batch)
    for key in ("loss", "grad_norm", "nll"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(
            float(jm[key])), key
    want = TT.params_from_jax(jax.tree.map(np.asarray, jp2), tc,
                              device="cpu")
    diffs = torch.cat([(got.detach() - ref).abs().flatten() for (_, got),
                       (_, ref) in zip(flatten(tp), flatten(want))])
    assert float(diffs.max()) <= STEP_ABS_TOL * ttc.lr, float(diffs.max())
    assert float((diffs > 1e-6).float().mean()) <= STEP_OUTLIERS
    assert opt.step_count == 1


def test_serve_and_prefill_builders_run_without_autograd():
    """``prefill_fn``/``serve_step_fn`` on trainable parameters: the same
    logits as ``T.prefill``/``T.decode_step`` under ``no_grad``, and no
    graph (the flash and GEMM kernels would refuse one on the card)."""
    cfg = get_config("qwen2-1.5b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    params = TT.init_params(0, cfg, device="cpu")
    TS.trainable(params)
    toks = torch.from_numpy(_lm_batch(cfg.vocab, 2, 9, seed=4)["tokens"])
    logits, cache = TS.prefill_fn(cfg, 16)(params, {"tokens": toks})
    with torch.no_grad():
        want, _ = TT.prefill(params, {"tokens": toks}, cfg, 16)
    assert logits.grad_fn is None and torch.equal(logits, want)
    nxt, cache = TS.serve_step_fn(cfg)(params, cache,
                                       logits.argmax(-1)[:, None])
    assert nxt.grad_fn is None and nxt.shape == (2, cfg.vocab)
    assert bool((cache["pos"] == 10).all())


# ---------------------------------------------------------- embedding (NaN)

def test_embedding_fill_matches_jnp_take():
    """Out-of-range ids give NaN rows, as ``jnp.take``'s default fill mode
    does (negative ids in [-V, 0) count from the end); nothing raises."""
    table = _rng_normal(11, (6, 4))
    ids = np.array([[0, 5, -1, -6], [-7, 6, -(2 ** 31) + 7, 2 ** 31 - 1]],
                   np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = TT.embed(torch.from_numpy(table), torch.from_numpy(ids),
                   torch.float32).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_injected_nan_batch_gives_nan_loss():
    """The trainer's NaN fault (tokens -(2**31)+7) reaches a NaN loss
    through the embedding's fill, where indexing would raise."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = TT.init_params(0, cfg, device="cpu")
    batch = _lm_batch(cfg.vocab, 2, 8, seed=1)
    batch["tokens"] = np.full_like(batch["tokens"], -(2 ** 31) + 7)
    loss, _ = TT.loss_fn(params, TS.to_device(batch, "cpu"), cfg)
    assert torch.isnan(loss)


# ------------------------------------------------------------ RMSNorm Function

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
def test_rmsnorm_function_backward_matches_autograd_of_plain(dtype, tol):
    """On the CPU the Function's forward is the plain version; its
    analytic backward against autograd through ``rmsnorm_plain`` on the
    fp32 values of the same inputs (fp32 within 1e-5 of max |grad|; bf16,
    rounded once, within 1e-2).  Over more than one 128-row tile,
    autograd through the bf16 plain version would sum the tiles' dw in
    bf16; 300 rows here take three tiles."""
    rng = np.random.default_rng(12)
    x0 = torch.from_numpy(rng.standard_normal((3, 100, 48)).astype(
        np.float32) * 3).to(dtype)
    w0 = torch.from_numpy(rng.standard_normal(48).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((3, 100, 48)).astype(
        np.float32)).to(dtype)
    x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    out = TR.rmsnorm(x, w)
    assert out.grad_fn is not None and "RMSNorm" in type(out.grad_fn).__name__
    dx, dw = torch.autograd.grad(out, (x, w), g)
    x2, w2 = (t.float().clone().requires_grad_(True)
              for t in (x0, w0))
    px, pw = torch.autograd.grad(TR.rmsnorm_plain(x2, w2), (x2, w2),
                                 g.float())
    assert torch.equal(out.detach(), TR.rmsnorm_plain(x0, w0))
    assert dx.dtype == dtype and dw.dtype == dtype
    assert _rel(dx, px.float().numpy()) <= tol
    assert _rel(dw, pw.float().numpy()) <= tol
    assert TR.rmsnorm(x0, w0).grad_fn is None        # no autograd, no Function


# ----------------------------------------------------------------------- data

def test_data_batches_byte_equal_reference():
    for cfg in (dict(vocab=151936, seq_len=64, global_batch=4, seed=0),
                dict(vocab=64, seq_len=16, global_batch=4, seed=3,
                     n_hosts=2, host_id=1, structure=8)):
        jds, tds = JD.SyntheticLM(JD.DataConfig(**cfg)), TD.SyntheticLM(
            TD.DataConfig(**cfg))
        for step in (0, 7):
            a, b = jds.batch_at(step), tds.batch_at(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
    cfg = dict(vocab=64, seq_len=8, global_batch=2, seed=0)
    ds = JD.SyntheticLM(JD.DataConfig(**cfg))
    pf = TD.Prefetcher(TD.SyntheticLM(TD.DataConfig(**cfg)), start_step=5)
    try:
        for step in (5, 6, 7):
            assert pf.next()["tokens"].tobytes() == ds.batch_at(
                step)["tokens"].tobytes()
        assert pf.state()["step"] == 8
    finally:
        pf.close()


# ------------------------------------------------------- forward-only kernels

def test_forward_only_kernels_refuse_autograd_inputs():
    """The flash and GEMM kernels have no backward: on a non-CPU tensor
    that requires grad (a meta tensor here, which reaches the kernel
    branch without a card) they raise instead of returning a tensor with
    no grad_fn; under ``no_grad`` they get past the check."""
    q = torch.empty((1, 8, 2, 16), device="meta", requires_grad=True)
    a = torch.empty((8, 8), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        TF.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="forward-only"):
        TG.gemm(a, a)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors"):
            TF.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="CUDA tensors"):
            TG.gemm(a, a)
