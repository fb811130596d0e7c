"""Kimi-Linear-48B-A3B (``kimi-linear-48b-a3b``: KDA linear attention 3 : 1
beside NoPE MLA, sigmoid routing over 256 experts of which one chip holds
32) on its reduced config with seeded random weights, against the plain
float32 reference ``dcoc_bench/reference/kimi_linear.py``: prefill
logits; prefill, then decode through ``Server`` against the reference's
full forward; KDA's chunked prefill against its recurrence at lengths
that are no multiple of the chunk; the NoPE MLA against the reference's;
the expert shares summing to the uncut layer; the dispatch's counters;
each planted fault caught.  The reference replays the program's expert
sets (``moe.route_log``).  Also the config as published, its
registration, the spans and counters, and the kernel wrappers' refusals
on the CPU."""
import contextlib
import math
import os
import sys

import numpy as np
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro_torch import obs
from repro_torch.configs import PORT_ARCH_NAMES, get_config
from repro_torch.configs import kimi_linear_48b_a3b as KIMI
from repro_torch.kernels import kda_decode as KK
from repro_torch.models import kda as KDA
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from dcoc_bench import harness  # noqa: E402
from dcoc_bench.reference import kimi_linear as REF  # noqa: E402

# x max |reference logit|: fp32 sums in other orders (the chunked form
# beside the recurrence); bf16 rounds every activation of 7 layers
TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-2}


def _cfg(dtype=torch.float32):
    return get_config("kimi-linear-48b-a3b", reduced=True).with_(
        dtype=dtype, param_dtype=dtype)


def _hf(cfg) -> dict:
    """The reference's config.json keys of a program config."""
    full = [i + 1 for i, (m, _) in enumerate(cfg.layer_kinds())
            if m == "mla"]
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "mla_use_nope": cfg.mla_nope,
            "rms_norm_eps": cfg.rms_norm_eps,
            "num_experts_per_token": cfg.moe_top_k,
            "num_experts": cfg.experts_held,
            "routed_scaling_factor": cfg.routed_scaling,
            "first_k_dense_replace": cfg.first_k_dense,
            "linear_attn_config": {
                "full_attn_layers": full, "num_heads": cfg.kda_heads,
                "head_dim": cfg.kda_head_dim,
                "short_conv_kernel_size": cfg.kda_conv},
            "deployment": {"experts_held_from": cfg.experts_held_from,
                           "num_experts_published": cfg.n_experts}}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.fixture
def logged():
    """``moe.route_log`` on for the test, off after it."""
    MOE.route_log = []
    yield MOE.route_log
    MOE.route_log = None


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_prefill_logits_match_reference(dtype, logged):
    cfg = _cfg(dtype)
    params = T.init_params(3, cfg, device="cpu")
    tokens = _prompts(cfg, [70])[0]       # two chunks, the second short
    logits, _ = T.prefill(params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.long)[None]}, cfg, max_len=96)
    ref = REF.forward(_hf(cfg), params, [torch.as_tensor(tokens)],
                      [[len(tokens) - 1]], routes=[[t.clone()
                                                    for t in logged]])
    assert _rel(logits[0], ref["logits"][0][0]) < TOL[dtype]
    assert ref["route_tokens"] == 70 * (cfg.n_layers - 1)
    if dtype == torch.float32:
        assert ref["route_mismatch"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_server_prefill_then_decode_matches_reference(dtype, logged):
    """Two slots admitted (prefill each: KDA's chunked form leaves the
    state and the conv tails in the cache), then 8 decode steps; each
    step's logits against the reference's full forward over prompt and
    outputs, KDA by its recurrence, with the program's expert sets
    replayed."""
    cfg = _cfg(dtype)
    params = T.init_params(5, cfg, device="cpu")
    server = Server(params, cfg, n_slots=2, max_len=96)
    prompts = _prompts(cfg, [11, 67], seed=1)
    reqs = [server.submit(Request(uid=i, prompt=p, max_new_tokens=20))
            for i, p in enumerate(prompts)]
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    steps, logits = [], []
    for _ in range(9):
        server.step()
        steps.append(list(logged))
        logged.clear()
        logits.append(server.last_logits.clone())
    prefill = steps[0][:2 * n_moe]
    steps[0] = steps[0][2 * n_moe:]
    slot = {r.uid: s for s, r in server.active.items()}
    for r, req in enumerate(reqs):
        n, s = len(req.prompt), slot[r]
        seq = torch.as_tensor(list(req.prompt) + req.output[:9])
        routes = [torch.cat([prefill[r * n_moe + m]]
                            + [steps[j][m][s:s + 1] for j in range(9)])
                  for m in range(n_moe)]
        ref = REF.forward(_hf(cfg), params, [seq],
                          [[n + j for j in range(9)]], routes=[routes])
        for j in range(9):
            assert _rel(logits[j][s], ref["logits"][0][j]) < TOL[dtype]
        assert int(logits[8][s].argmax()) == req.output[9]


@pytest.mark.parametrize("length", [1, 3, 63, 65, 130, 200])
def test_chunked_prefill_matches_recurrence(length):
    """The WY form's chunks of 64 against the plain decode step a token
    at a time, from a state of its own, decays strong and weak: each
    output and the final state."""
    g = torch.Generator().manual_seed(length)
    b, h, d = 2, 3, 16
    rnd = lambda *s: torch.randn(s, generator=g)
    q, k, v = rnd(b, length, h, d), rnd(b, length, h, d), rnd(b, length, h, d)
    gate = -torch.rand((b, length, h, d), generator=g) * torch.tensor(
        [0.01, 1.0, 8.0])[:, None]
    beta = torch.rand((b, length, h), generator=g)
    state0 = rnd(b, h, d, d)
    scale = 1 / math.sqrt(d)
    out, state = KDA.chunk_delta(KDA.l2norm(q) * scale, KDA.l2norm(k), v,
                                 gate, beta, state0.clone())
    want_state = state0.clone()
    want = torch.stack([KK.kda_recurrence_plain(
        q[:, t], k[:, t], v[:, t], gate[:, t], beta[:, t], want_state,
        scale) for t in range(length)], dim=1)
    assert out.shape == (b, length, h, d)
    assert _rel(out, want) < 1e-5
    assert _rel(state, want_state) < 1e-5


def test_nope_mla_matches_reference():
    """One MLA layer (prefill's expanded form) against the reference's,
    with no rotation at all, and the absorbed decode against the
    expanded form at the next position; rotating the rope columns
    changes the output."""
    cfg = _cfg()
    params = T.init_params(7, cfg, device="cpu")
    p = params["layers"][3]["mix"]
    x = torch.randn((1, 19, cfg.d_model), generator=torch.Generator(
        ).manual_seed(1))
    pos = torch.arange(19)[None]
    got, ckv, kpe = MLA.mla_block(x, p, cfg, pos)
    ops = REF._Ops(_hf(cfg), None)
    want = REF._mla(ops, x[0], {k: t.float() for k, t in p.items()})
    assert _rel(got[0], want) < 1e-5
    roped, _, _ = MLA.mla_block(x, p, cfg.with_(mla_nope=False), pos)
    assert _rel(roped[0], want) > 1e-2
    entry = MLA.init_latent_cache(cfg, 1, 32, "cpu")
    entry["ckv"][:, :18], entry["kpe"][:, :18] = ckv[:, :18], kpe[:, :18]
    step = MLA.decode_state(torch.tensor([18], dtype=torch.int32), 32, cfg)
    assert step["tables"] is None
    out = MLA.mla_decode(x[:, 18:], p, cfg, entry, step, 19)
    assert _rel(out[0, 0], got[0, 18]) < 1e-5


def test_expert_shares_sum_to_uncut_layer():
    """The layer cut in 2 shares of 4 of its 8 experts: each share's
    output less the shared expert's (counted once) and the residual adds
    up to the uncut layer's, and to the reference's with every expert
    held; the router picks from all 8 in each share."""
    cfg = _cfg()
    whole = cfg.with_(n_experts_held=0)
    params = T.init_params(9, whole, device="cpu")
    p = params["layers"][1]["ffn"]
    x = torch.randn((3, 21, cfg.d_model), generator=torch.Generator(
        ).manual_seed(2))
    want, _ = MOE.moe_block(x, p, whole)
    h = T.L.rmsnorm(x, p["ln"], cfg.rms_norm_eps).reshape(-1, cfg.d_model)
    shared = MOE.shared_expert(h, p).reshape(x.shape)
    total = x + shared
    for first in (0, 4):
        share = dict(p, **{w: p[w][first:first + 4]
                           for w in ("w_gate", "w_up", "w_down")})
        got, _ = MOE.moe_block(x, share, cfg.with_(experts_held_from=first))
        total = total + (got - x - shared)
    assert _rel(total - x, want - x) < 1e-5
    hf = dict(_hf(whole), num_experts=8)
    ref = REF._moe(REF._Ops(hf, None), x.reshape(-1, cfg.d_model), p, None,
                   [0, 0], [])
    assert _rel(total.reshape(-1, cfg.d_model) - x.reshape(-1, cfg.d_model),
                ref - x.reshape(-1, cfg.d_model)) < 1e-5


def test_grouped_share_matches_dense_and_counts(logged):
    """The held share's grouped dispatch against every held expert on
    every token (bf16: ``torch._grouped_mm``; fp32: the loop), with the
    counters: no held pair dropped, and the pairs routed off the chip
    those whose expert lies outside the held range."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        cfg = _cfg(dtype).with_(experts_held_from=2)
        params = T.init_params(11, cfg, device="cpu")
        p = params["layers"][1]["ffn"]
        assert p["w_gate"].shape[0] == 4 and p["router"].shape[-1] == 8
        x = torch.randn((2, 33, cfg.d_model), generator=torch.Generator(
            ).manual_seed(3)).to(dtype)
        tracer = obs.Tracer()
        logged.clear()
        with obs.use(tracer):
            got, _ = MOE.moe_block(x, p, cfg)
        want, _ = MOE.moe_block(x, p, cfg.with_(moe_impl="dense"))
        assert _rel(got - x, want - x) < tol
        counters = tracer.metrics.snapshot()["counters"]
        sets = logged[0]
        held = ((sets >= 2) & (sets < 6)).sum()
        assert float(counters["moe.tokens_dropped"]) == 0
        assert float(counters["moe.pairs_elsewhere"]) == sets.numel() - held
        assert float(counters["moe.experts_touched"]) == len(
            [e for e in torch.unique(sets).tolist() if 2 <= e < 6])


def test_spans_and_counters_of_prefill_and_decode(logged):
    cfg = _cfg(torch.bfloat16)
    params = T.init_params(13, cfg, device="cpu")
    tracer = obs.Tracer()
    toks = torch.as_tensor(np.stack(_prompts(cfg, [70, 70])))
    with obs.use(tracer):
        _, cache = T.prefill(params, {"tokens": toks}, cfg, 96)
        T.decode_step(params, cache, torch.tensor([[1], [2]]), cfg)
    counters = tracer.metrics.snapshot()["counters"]
    kinds = [m for m, _ in cfg.layer_kinds()]
    # 2 sequences x 2 chunks, each KDA layer
    assert counters["kda.prefill_chunks"] == 4 * kinds.count("kda")
    assert float(counters["moe.tokens_dropped"]) == 0
    names = [s["name"] for s in tracer.spans()]
    assert names.count("kda") == 2 * kinds.count("kda")
    assert names.count("mla") == 2 * kinds.count("mla")
    assert names.count("mlp") == 2 and names.count("moe") == 2 * 6
    entry = cache["layers"][0]
    assert entry["S"].dtype == torch.float32
    assert entry["S"].shape == (2, cfg.kda_heads, cfg.kda_head_dim,
                                cfg.kda_head_dim)
    assert entry["conv_q"].shape == (2, cfg.kda_conv - 1,
                                     cfg.kda_heads * cfg.kda_head_dim)


def test_decode_hands_the_kernel_contiguous_fp32(monkeypatch):
    """What the mixer hands the KDA decode kernel is what the kernel takes
    on the card: q, k, v, g (B, H, d), beta (B, H) and the state, fp32
    and contiguous."""
    cfg = _cfg(torch.bfloat16)
    params = T.init_params(14, cfg, device="cpu")
    _, cache = T.prefill(params, {"tokens": torch.as_tensor(np.stack(
        _prompts(cfg, [5, 5])))}, cfg, 16)
    seen = []
    real = KK.kda_recurrence

    def spy(q, k, v, g, beta, state, scale, use_kernel=True):
        seen.append((q, k, v, g, beta, state))
        return real(q, k, v, g, beta, state, scale, use_kernel)

    monkeypatch.setattr(KK, "kda_recurrence", spy)
    T.decode_step(params, cache, torch.tensor([[1], [2]]), cfg)
    assert len(seen) == [m for m, _ in cfg.layer_kinds()].count("kda")
    for ops in seen:
        assert all(t.is_contiguous() and t.dtype == torch.float32
                   for t in ops)
        assert ops[0].shape == (2, cfg.kda_heads, cfg.kda_head_dim)
        assert ops[4].shape == (2, cfg.kda_heads)


def test_short_prompt_conv_tails_and_admission_copy():
    """A prompt shorter than the conv's taps leaves zeros ahead of its
    inputs in the tails; admission copies the state and the tails into
    the server's slot."""
    cfg = _cfg()
    params = T.init_params(15, cfg, device="cpu")
    server = Server(params, cfg, n_slots=3, max_len=32)
    req = server.submit(Request(uid=0, prompt=np.array([5, 9], np.int32),
                                max_new_tokens=4))
    _, single = T.prefill(params, {"tokens": torch.tensor([[5, 9]])}, cfg, 32)
    server._admit()
    slot = next(s for s, r in server.active.items() if r is req)
    for got, want in zip(server.cache["layers"], single["layers"]):
        for key, t in want.items():
            if key in ("S", "conv_q", "conv_k", "conv_v"):
                assert torch.equal(got[key][slot], t[0])
    tail = single["layers"][0]["conv_q"][0]
    assert float(tail[0].abs().max()) == 0 and float(tail[1:].abs().min()) > 0


def test_config_as_published():
    cfg = get_config("kimi-linear-48b-a3b")
    assert "kimi-linear-48b-a3b" in PORT_ARCH_NAMES
    kinds = cfg.layer_kinds()
    assert [i + 1 for i, (m, _) in enumerate(kinds) if m == "mla"] == list(
        KIMI.FULL_ATTN_LAYERS) == [4, 8, 12, 16, 20, 24, 27]
    assert [i + 1 for i, (m, _) in enumerate(kinds) if m == "kda"] == list(
        KIMI.KDA_LAYERS)
    assert kinds[0] == ("kda", "mlp") and kinds[26] == ("mla", "moe")
    assert (cfg.n_experts, cfg.experts_held, cfg.moe_top_k) == (256, 32, 8)
    assert T.param_count(T.abstract_params(cfg)) == 7_901_062_016
    small = get_config("kimi-linear-48b-a3b", reduced=True)
    assert [m for m, _ in small.layer_kinds()] == [
        "kda", "kda", "kda", "mla", "kda", "kda", "mla"]
    assert (small.n_experts, small.experts_held) == (8, 4)
    with pytest.raises(ValueError):
        cfg.with_(layer_mixers=("kda",) * 3)
    with pytest.raises(ValueError):
        cfg.with_(experts_held_from=240)


def test_kernel_wrappers_take_cpu_tensors_plainly():
    """On the CPU the KDA step runs its plain version (no launch), and
    the refusal names what a CUDA call would lack."""
    b, h, d = 2, 3, 128
    rnd = lambda *s: torch.randn(s)
    state = rnd(b, h, d, d)
    before = KK.kda_recurrence.launches
    out = KK.kda_recurrence(rnd(b, h, d), rnd(b, h, d), rnd(b, h, d),
                            -torch.rand(b, h, d), torch.rand(b, h), state,
                            d ** -0.5)
    assert out.shape == (b, h, d) and KK.kda_recurrence.launches == before
    assert "CUDA" in KK.kernel_refusal(*(rnd(b, h, d),) * 4, rnd(b, h),
                                       state)


from dcoc_bench.test_dcoc_bench_kimi import CELL, MIX, SEED, TINY  # noqa

# the faults the cell's limits catch: all of them
CAUGHT = list(harness.generator("serve_decode_kda").FAULTS)


def _tiny(fault=None):
    gen = harness.generator("serve_decode_kda")
    with gen.planted(fault) if fault else contextlib.nullcontext():
        return harness.run_local(CELL, SEED, 0.2, mix_overrides=MIX,
                                 config_overrides=TINY)[1]


@pytest.mark.parametrize("fault", CAUGHT)
def test_planted_faults_are_not_correct(fault):
    assert _tiny(fault)["correct"] is False


def test_state_in_bf16_shows_in_an_fp32_program():
    """The fp32 program with its KDA states rounded to bf16 after every
    decode step reads a logit gap over a thousand times its own (bf16's
    2^-8 against fp32's sums): the rounding reaches the logits too."""
    clean = _tiny()["checks"]["logit_gap"]["value"]
    rounded = _tiny("state_bf16")["checks"]["logit_gap"]["value"]
    assert rounded > 1000 * clean and rounded > 1e-3
