"""Port parity for the LM serving path: the port's transformer, given the
reference's weights (``params_from_jax``), against
``repro.models.transformer`` on the reduced qwen2-1.5b, the reduced MoE
and recurrent families (moonshot: MoE; mixtral: MoE with a sliding-window
ring cache; xlstm: mLSTM + sLSTM; jamba: Mamba + attention + MoE), the
encoder-decoder (whisper: encoder frames, cross attention, ``xk``/``xv``
in the cache) and the vision prefix (internvl2: patches ahead of the
tokens) — prefill logits and cache, then teacher-forced decode steps —
through both the kernel path (on the CPU: the kernels' plain versions)
and the plain path; a sliding-window variant decoding past its window
(ring cache); bf16; decode against the port's own prefill; the
encoder-decoder's parameter layout; config data."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT

SUPPORTED = tuple(ARCH_NAMES)
# the MoE and recurrent families, the encoder-decoder and the vision
# prefix, held end to end against the reference
NEW_FAMILIES = ("moonshot-v1-16b-a3b", "mixtral-8x22b", "xlstm-1.3b",
                "jamba-1.5-large-398b", "whisper-base", "internvl2-26b")
LOGIT_TOL = 1e-4          # x max |logit|, fp32
BF16_LOGIT_TOL = 5e-2     # x max |logit|: see test_bf16_prefill_and_decode


def _configs(dtype="fp32", arch="qwen2-1.5b", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    jc = jax_get_config(arch, reduced=True).with_(
        dtype=jd, param_dtype=jd, remat=False, **kw)
    tc = get_config(arch, reduced=True).with_(
        dtype=td, param_dtype=td, **kw)
    return jc, tc


def _models(dtype="fp32", arch="qwen2-1.5b", **kw):
    jc, tc = _configs(dtype, arch, **kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    decode = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jc))
    prefill = jax.jit(lambda p, b, n: JT.prefill(p, b, jc, n),
                      static_argnums=(2,))
    return jc, tc, jp, tp, decode, prefill


@pytest.fixture(scope="module")
def fp32_models():
    return _models()


@functools.lru_cache(maxsize=None)
def _family_models(arch):
    """The reduced family's fp32 models, made once per test module."""
    return _models(arch=arch)


@pytest.fixture(scope="module")
def family_models(fp32_models):
    """arch -> models (the reduced qwen2-1.5b's are ``fp32_models``)."""
    yield lambda arch: (fp32_models if arch == "qwen2-1.5b"
                        else _family_models(arch))
    _family_models.cache_clear()


@pytest.fixture(scope="module")
def swa_models():
    return _models(pattern=(("swa", "mlp"),), swa_window=16)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


def _frontend(cfg, b, seed):
    """The stub frontends' inputs as numpy fp32, drawn from ``seed``: a
    vision prefix's patches (B, P, D), an encoder's frames (B, F, D);
    as the reference's tests/test_models.py builds them."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.vision_prefix:
        out["patches"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg, tokens, seed):
    """The same batch for both packages: (jax, torch)."""
    batch = dict(_frontend(cfg, tokens.shape[0], seed), tokens=tokens)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


# the reference's cache key of a recurrent mixer's state (a NamedTuple
# whose fields are the port's keys)
_STATE_KEY = {"mamba": "ssm", "mlstm": "lstm", "slstm": "slstm"}


def _check_cache(tc, tcache, jcache):
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for i, (entry, (mixer, _)) in enumerate(zip(tcache["layers"],
                                                tc.layer_kinds())):
        ref = jcache["layers"][i % tc.period]
        if mixer in _STATE_KEY:
            ref = ref[_STATE_KEY[mixer]]._asdict()
        assert set(entry) == set(ref), (i, mixer)
        for key in entry:
            got = entry[key].float().numpy()
            want = np.asarray(ref[key][i // tc.period], np.float32)
            if mixer not in _STATE_KEY:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                continue
            # a recurrent state carries every step's rounding through the
            # stack (the last sLSTM's h after 21 steps of 8 layers: 3.6e-5
            # of its max): held to the logits' 1e-4 of the field's max
            # |value|, the stabilizer's -1e30 exactly
            live = np.abs(want) < 1e29
            np.testing.assert_array_equal(got[~live], want[~live])
            scale = float(np.abs(want[live]).max(initial=0.0))
            assert float(np.abs(got[live] - want[live]).max(initial=0.0)) \
                <= LOGIT_TOL * scale, (i, mixer, key)


def _prefill_then_decode(models, s0, max_len, steps, use_kernel, tol,
                         seed=0, check_cache=True):
    jc, tc, jp, tp, jdecode, jprefill = models
    toks = _tokens(jc.vocab, 2, s0 + steps, seed)
    jb, tb = _batches(tc, toks[:, :s0], seed)
    jl, jcache = jprefill(jp, jb, max_len)
    tl, tcache = TT.prefill(tp, tb, tc, max_len, use_kernel=use_kernel)
    assert tl.shape == (2, tc.vocab) and tl.dtype == torch.float32
    assert _rel(tl, jl) <= tol
    if check_cache:
        _check_cache(tc, tcache, jcache)
    for i in range(s0, s0 + steps):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = TT.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]), tc,
                                    use_kernel=use_kernel)
        assert _rel(tl, jl) <= tol, i
    if check_cache:
        _check_cache(tc, tcache, jcache)


@pytest.mark.parametrize(
    "arch,use_kernel",
    [(a, k) for a in ("qwen2-1.5b",) + NEW_FAMILIES for k in (True, False)],
    ids=[(f"{a}-" if a != "qwen2-1.5b" else "")
         + ("kernel_path" if k else "plain_path")
         for a in ("qwen2-1.5b",) + NEW_FAMILIES for k in (True, False)])
def test_prefill_and_decode_match_reference(family_models, arch, use_kernel):
    """Prompts of 13 tokens, 8 decode steps, cache of 32: mixtral's window
    of 16 makes its cache a ring that decode wraps; xlstm's and jamba's
    chunks of 8 end the prefill in a padded chunk; whisper's encoder runs
    over 32 drawn frames (its cache's ``xk``/``xv`` held at 1e-5);
    internvl2's 8 drawn patches put the prompt at positions 8-20."""
    _prefill_then_decode(family_models(arch), s0=13, max_len=32, steps=8,
                         use_kernel=use_kernel, tol=LOGIT_TOL)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel_path", "plain_path"])
def test_swa_ring_cache_decodes_past_window(swa_models, use_kernel):
    """Window 16, cache of 16 (a ring): the 20-token prefill already wraps
    the ring and decode runs 8 steps further."""
    jc, tc = swa_models[:2]
    assert TT._cache_seq_len(tc, "swa", 32) == 16
    _prefill_then_decode(swa_models, s0=20, max_len=32, steps=8,
                         use_kernel=use_kernel, tol=LOGIT_TOL, seed=1)


def test_bf16_prefill_and_decode():
    """bf16 weights and activations.  The port's norms compute in fp32 and
    round once (the RMSNorm kernel); the reference's jnp norm multiplies in
    bf16, and every projection rounds its output to bf16 at places XLA and
    PyTorch choose differently.  Over 2 layers that is a few bf16 steps
    (2^-8 relative) of a logit: 1.0e-2 to 1.6e-2 of max |logit| measured
    on the CPU, held to 5e-2."""
    models = _models("bf16")
    _prefill_then_decode(models, s0=11, max_len=24, steps=4, use_kernel=True,
                         tol=BF16_LOGIT_TOL, check_cache=False)


@pytest.mark.parametrize("arch", ("qwen2-1.5b",) + NEW_FAMILIES)
def test_decode_reproduces_own_prefill(family_models, arch):
    """Teacher-forced decode must reproduce the port's own prefill logits
    (the reference's test_decode_matches_prefill_fp32)."""
    tc, tp = family_models(arch)[1], family_models(arch)[3]
    toks = _tokens(tc.vocab, 1, 13, seed=2)
    _, short = _batches(tc, toks[:, :-1], seed=2)
    _, full = _batches(tc, toks, seed=2)
    _, cache = TT.prefill(tp, short, tc, max_len=32)
    ld, cache = TT.decode_step(tp, cache, full["tokens"][:, -1:], tc)
    lfull, _ = TT.prefill(tp, full, tc, max_len=32)
    np.testing.assert_allclose(ld.numpy(), lfull.numpy(), rtol=1e-3,
                               atol=1e-4)
    assert int(cache["pos"][0]) == 13 + tc.vision_prefix


def test_params_from_jax_layout(fp32_models):
    """Unstacked reference weights have the shapes of the port's own
    seeded init, layer by layer."""
    jc, tc, jp, tp = fp32_models[:4]
    own = TT.init_params(0, tc, device="cpu")
    assert len(tp["layers"]) == len(own["layers"]) == tc.n_layers
    assert TT.param_count(tp) == TT.param_count(own) == sum(
        int(np.size(x)) for x in jax.tree.leaves(jp))
    for mine, theirs in zip(own["layers"], tp["layers"]):
        for part in ("mix", "ffn"):
            assert {k: tuple(v.shape) for k, v in mine[part].items()} == {
                k: tuple(v.shape) for k, v in theirs[part].items()}
    np.testing.assert_array_equal(
        tp["layers"][1]["mix"]["wq"].numpy(),
        np.asarray(jp["layers"][0]["mix"]["wq"][1]))


def test_params_from_jax_encoder_decoder_layout(family_models):
    """whisper: the encoder's stacked layers unstack into ``enc_layers``
    (attn + gelu), ``enc_ln`` is carried, every decoder layer has a
    ``cross`` part without biases; the shapes are the port's own init's
    and the values the reference's."""
    jc, tc, jp, tp = family_models("whisper-base")[:4]
    own = TT.init_params(0, tc, device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in tree.items()}
    assert set(tp) == set(own) == set(jp) == {
        "embed", "final_ln", "lm_head", "layers", "enc_layers", "enc_ln"}
    assert len(tp["enc_layers"]) == len(own["enc_layers"]) == \
        tc.n_enc_layers
    for mine, theirs in zip(own["enc_layers"], tp["enc_layers"]):
        assert set(theirs) == {"mix", "ffn"}
        for part in ("mix", "ffn"):
            assert shapes(mine[part]) == shapes(theirs[part])
        assert "w_in" in theirs["ffn"] and "bq" not in theirs["mix"]
    for mine, theirs in zip(own["layers"], tp["layers"]):
        assert set(theirs) == {"mix", "cross", "ffn"}
        assert shapes(mine["cross"]) == shapes(theirs["cross"])
        assert set(theirs["cross"]) == {"ln", "wq", "wk", "wv", "wo"}
    np.testing.assert_array_equal(
        tp["enc_layers"][1]["mix"]["wk"].numpy(),
        np.asarray(jp["enc_layers"][0]["mix"]["wk"][1]))
    np.testing.assert_array_equal(
        tp["layers"][1]["cross"]["wv"].numpy(),
        np.asarray(jp["layers"][0]["cross"]["wv"][1]))
    np.testing.assert_array_equal(tp["enc_ln"].numpy(),
                                  np.asarray(jp["enc_ln"]))
    assert TT.param_count(tp) == TT.param_count(own) == sum(
        int(np.size(x)) for x in jax.tree.leaves(jp))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_hold_the_reference_data(arch):
    for reduced in (False, True):
        mine = dataclasses.asdict(get_config(arch, reduced))
        theirs = dataclasses.asdict(jax_get_config(arch, reduced))
        for key in ("dtype", "param_dtype"):
            assert str(mine.pop(key)).split(".")[-1] == str(
                np.dtype(theirs.pop(key)))
        assert mine == theirs


@pytest.mark.parametrize("arch", SUPPORTED)
def test_supported_archs_serve_reduced(arch):
    cfg = get_config(arch, reduced=True).with_(dtype=torch.float32,
                                               param_dtype=torch.float32)
    params = TT.init_params(0, cfg, device="cpu")
    _, batch = _batches(cfg, _tokens(cfg.vocab, 2, 9, seed=3), seed=3)
    logits, cache = TT.prefill(params, batch, cfg,
                               max_len=16 + cfg.vision_prefix)
    logits2, cache2 = TT.decode_step(params, cache, logits.argmax(-1)[:, None],
                                     cfg)
    assert logits2.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits2).all())
    assert bool((cache2["pos"] == 10 + cfg.vision_prefix).all())


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen2-1.5b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(0, cfg)
