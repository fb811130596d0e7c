"""Moonlight-16B-A3B (``moonlight-16b-a3b``, the port's DeepSeek-V3 block:
MLA with a latent cache, sigmoid routing with a correction bias and
shared experts, a dense layer 0) on its reduced config with seeded random
weights, against the plain float32 reference
``dcoc_bench/reference/deepseek_v3.py``: prefill logits; prefill, then
decode through ``Server`` against the reference's full forward; the
absorbed decode against the expanded form; the ``grouped`` MoE against
``dense`` on the same routing; the dispatch drops nothing; each planted
fault is caught.  The reference replays the program's expert sets
(``moe.route_log``), so that a near tie in the router cannot flip a
layer's experts between the two.  Also the config as published, the
flash kernel's dp=192 template rule, and the spans and counters."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro_torch import obs
from repro_torch.configs import ARCH_NAMES, PORT_ARCH_NAMES, get_config
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from dcoc_bench.reference import deepseek_v3 as REF  # noqa: E402

# x max |reference logit|: fp32 sums in other orders; bf16 rounds every
# activation of 3 layers (the harness's bf16 tiny run reads ~2e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


def _cfg(dtype=torch.float32):
    return get_config("moonlight-16b-a3b", reduced=True).with_(
        dtype=dtype, param_dtype=dtype)


def _hf(cfg) -> dict:
    """The reference's config.json keys of a program config."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "num_experts_per_tok": cfg.moe_top_k,
            "routed_scaling_factor": cfg.routed_scaling,
            "first_k_dense_replace": cfg.first_k_dense}


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


def _prefill_gap(cfg, params, log, tokens) -> float:
    logits, _ = T.prefill(params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.long)[None]}, cfg, max_len=64)
    routes = [[t.clone() for t in log]]
    ref = REF.forward(_hf(cfg), params, [torch.as_tensor(tokens)],
                      [[len(tokens) - 1]], routes=routes)
    return _rel(logits[0], ref["logits"][0][0]), ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_prefill_logits_match_reference(dtype, logged):
    cfg = _cfg(dtype)
    params = T.init_params(3, cfg, device="cpu")
    tokens = _prompts(cfg, [23])[0]
    gap, ref = _prefill_gap(cfg, params, logged, tokens)
    assert gap < TOL[dtype]
    # two MoE layers of 23 tokens each, replayed
    assert ref["route_tokens"] == 46
    if dtype == torch.float32:
        assert ref["route_mismatch"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_server_prefill_then_decode_matches_reference(dtype, logged):
    """Two slots admitted (prefill each), then 8 decode steps; each
    step's logits against the reference's full forward over prompt and
    outputs, with the program's expert sets replayed."""
    cfg = _cfg(dtype)
    params = T.init_params(5, cfg, device="cpu")
    server = Server(params, cfg, n_slots=2, max_len=48)
    prompts = _prompts(cfg, [11, 17], seed=1)
    reqs = [server.submit(Request(uid=i, prompt=p, max_new_tokens=30))
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


def test_absorbed_decode_matches_expanded():
    """Decode (absorbed, reading the latent cache) against the prefill's
    expanded form over the same tokens, fp32, one slot at each of two
    depths."""
    cfg = _cfg()
    params = T.init_params(7, cfg, device="cpu")
    toks = torch.as_tensor(np.stack(_prompts(cfg, [13, 13], seed=2)))
    _, cache = T.prefill(params, {"tokens": toks}, cfg, max_len=32)
    cache["pos"] = torch.tensor([13, 9], dtype=torch.int32)  # slot 1 shorter
    nxt = torch.tensor([[5], [6]])
    logits, cache = T.decode_step(params, cache, nxt, cfg)
    for b, n in ((0, 13), (1, 9)):
        seq = torch.cat([toks[b, :n], nxt[b]])[None]
        want, _ = T.prefill(params, {"tokens": seq}, cfg, max_len=32)
        assert _rel(logits[b], want[0]) < 1e-5
    assert cache["layers"][0]["ckv"].shape == (2, 32, cfg.kv_lora_rank)
    assert cache["layers"][0]["kpe"].shape == (2, 32, cfg.qk_rope_head_dim)
    assert cache["pos"].tolist() == [14, 10]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_grouped_moe_matches_dense_on_same_routing(dtype):
    """``grouped`` (bf16: ``torch._grouped_mm``; fp32: the loop over the
    experts with rows) against every expert on every token, weights zero
    where unchosen: one router, so one routing."""
    cfg = _cfg(dtype)
    params = T.init_params(9, cfg, device="cpu")
    p = params["layers"][1]["ffn"]
    x = torch.randn((3, 21, cfg.d_model), generator=torch.Generator(
        ).manual_seed(0)).to(dtype)
    got, aux = MOE.moe_block(x, p, cfg)
    want, _ = MOE.moe_block(x, p, cfg.with_(moe_impl="dense"))
    assert aux is None
    assert _rel(got - x, want - x) < (1e-5 if dtype == torch.float32
                                      else 2e-2)


def test_grouped_dispatch_drops_nothing_and_counts(logged):
    cfg = _cfg(torch.bfloat16)
    params = T.init_params(11, cfg, device="cpu")
    tracer = obs.Tracer()
    with obs.use(tracer):
        T.prefill(params, {"tokens": torch.as_tensor(
            _prompts(cfg, [40])[0], dtype=torch.long)[None]}, cfg, 48)
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    assert len(logged) == n_moe
    counters = tracer.metrics.snapshot()["counters"]
    assert float(counters["moe.tokens_dropped"]) == 0
    # the experts the router chose, a layer
    assert float(counters["moe.experts_touched"]) == sum(
        len(torch.unique(sets)) for sets in logged)
    names = [s["name"] for s in tracer.spans()]
    assert names.count("mla") == cfg.n_layers
    assert names.count("moe") == n_moe and names.count("mlp") == 1


def test_decode_counts_latent_positions_read():
    cfg = _cfg()
    params = T.init_params(13, cfg, device="cpu")
    toks = torch.as_tensor(np.stack(_prompts(cfg, [6, 6])))
    _, cache = T.prefill(params, {"tokens": toks}, cfg, max_len=16)
    tracer = obs.Tracer()
    with obs.use(tracer):
        T.decode_step(params, cache, torch.tensor([[1], [2]]), cfg)
    counters = tracer.metrics.snapshot()["counters"]
    # 2 slots x 7 positions, every layer
    assert counters["mla.cache_tokens"] == 2 * 7 * cfg.n_layers


def _bias_ignored(real):
    return lambda h, p, cfg: real(h, dict(p, bias=p["bias"] * 0), cfg)


def _no_scaling(real):
    def route(h, p, cfg):
        w, idx = real(h, p, cfg)
        return w / cfg.routed_scaling, idx
    return route


@pytest.mark.parametrize("module,name,make,caught", [
    (MOE, "route_sigmoid", _bias_ignored, "route"),
    (MOE, "route_sigmoid", _no_scaling, "logits"),
    (MOE, "shared_expert", lambda real: lambda h, p: real(h, p) * 0,
     "logits"),
    (MLA, "absorbed_weights", lambda real: lambda p, cfg: tuple(
        w.transpose(1, 2) for w in reversed(real(p, cfg))), "logits"),
], ids=["bias_ignored", "no_scaling", "shared_skipped",
        "decode_not_absorbed"])
def test_planted_faults_fail(module, name, make, caught, logged,
                             monkeypatch):
    """Each fault planted in the program: the decode logits or the expert
    sets part from the reference's far past the fp32 tolerance."""
    cfg = _cfg()
    params = T.init_params(17, cfg, device="cpu")
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    tokens = _prompts(cfg, [30], seed=3)[0]
    _, cache = T.prefill(params, {"tokens": torch.as_tensor(
        tokens[:-1], dtype=torch.long)[None]}, cfg, max_len=40)
    logits, _ = T.decode_step(params, cache, torch.as_tensor(
        tokens[-1:], dtype=torch.long)[None], cfg)
    routes = [torch.cat([logged[m], logged[m + len(logged) // 2]])
              for m in range(len(logged) // 2)]
    ref = REF.forward(_hf(cfg), params, [torch.as_tensor(tokens)], [[29]],
                      routes=[routes])
    gap = _rel(logits[0], ref["logits"][0][0])
    share = ref["route_mismatch"] / ref["route_tokens"]
    if caught == "route":
        assert share > 0.1
    else:
        assert gap > 100 * TOL[torch.float32]


def test_published_config():
    cfg = get_config("moonlight-16b-a3b")
    assert isinstance(cfg, T.MLAConfig)
    assert "moonlight-16b-a3b" in PORT_ARCH_NAMES
    assert "moonlight-16b-a3b" not in ARCH_NAMES
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == (
        27, 2048, 16, 163840)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.d_ff, cfg.n_shared_experts,
            cfg.dense_d_ff) == (64, 6, 1408, 2, 11264)
    assert cfg.layer_kinds()[:2] == [("mla", "mlp"), ("mla", "moe")]
    assert T.param_count(T.abstract_params(cfg)) == 15_960_110_208
    cache = T.init_cache(cfg, 64, 8192, device="meta")
    per_token = sum(t.element_size() * t.shape[2]
                    for e in cache["layers"] for t in e.values())
    assert per_token == 31_104          # 576 x 2 B x 27 layers
    # the existing configs keep their defaults
    assert get_config("qwen2-1.5b").rms_norm_eps == 1e-6
    assert get_config("mixtral-8x22b").moe_scoring == "softmax"


def test_reduced_is_the_same_block():
    full, small = get_config("moonlight-16b-a3b"), _cfg()
    for key in ("pattern", "moe_scoring", "moe_impl", "first_k_dense",
                "n_shared_experts", "routed_scaling", "rms_norm_eps"):
        assert getattr(small, key) == getattr(full, key)
    assert small.n_layers - small.first_k_dense >= 2


@pytest.mark.parametrize("d,dp", [(128, 128), (129, 192), (160, 192),
                                  (192, 192)])
def test_legalize_picks_dp192_for_mla_keys(d, dp):
    g = TF.legalize(128, 128, 4096, d, torch.bfloat16)
    assert g.dp == dp and g.smem_bytes <= TF.SMEM_BUDGET
    if dp == 192:
        assert (g.bq, g.bk) == (64, 32)
    with pytest.raises(ValueError):
        TF.legalize(128, 128, 4096, 193, torch.bfloat16)
    with pytest.raises(ValueError):
        TF.legalize(128, 128, 4096, 129)     # fp32 stops at 128


def test_dp192_compiles_only_the_templates_legalize_picks():
    """At dp 192 bk 64 is past the shared-memory budget, so legalize never
    keeps it, and ``dispatch_mma_dp`` in the CUDA source instantiates dp
    192 only up to bk 32 (nvcc time; no dead template)."""
    picked = {(g.bq, g.bk) for g in (
        TF.legalize(bq, bk, s, 192, torch.bfloat16)
        for bq in TF.BQ_TEMPLATES for bk in TF.BK_TEMPLATES
        for s in (1, 20, 40, 100, 4096))}
    assert {bk for _, bk in picked} == {16, 32}
    assert TF.RunGeometry(16, 64, 192, "bfloat16").smem_bytes \
        > TF.SMEM_BUDGET
    src = Path(TF.__file__).parent / "csrc" / "flash_attention.cu"
    body = src.read_text().split("int dispatch_mma_dp(")[1].split(
        "\n}\n")[0]
    assert "if constexpr (BK <= 32) return launch_mma<BQ, BK, 192>(a);" \
        in body


def test_flash_plain_dp192_with_padded_values_is_attention():
    """MLA's prefill call: keys 192 wide, values 128 zero-padded to 192;
    the plain version of the bf16 geometry against softmax attention."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn((1, 40, 4, 192), generator=g).bfloat16()
            for _ in range(2))
    v = torch.randn((1, 40, 4, 128), generator=g).bfloat16()
    got = TF.flash_attention(q, k, torch.nn.functional.pad(v, (0, 64)))
    assert TF.flash_attention.last_geometry["run"]["dp"] == 192
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 192 ** 0.5
    sc = sc.masked_fill(torch.ones(40, 40).triu(1).bool(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v.float())
    # P rounded to bf16 for P V, the output to bf16
    assert _rel(got[..., :128], want) < 1e-2
    assert got[..., 128:].abs().max() == 0


def test_mla_decode_split_rule():
    from repro_torch.kernels import mla_decode as MK
    # 64 slots at 4,610 positions: 145 tiles of 32, 9 splits of 17 tiles
    assert MK.kv_split(64, 4610) == (17, 9)
    assert MK.kv_split(600, 100) == (4, 1)       # the batch fills the card
    assert MK.kv_split(3, 40) == (1, 2)          # no more splits than tiles
    for b, n in ((1, 1), (64, 8192), (7, 333)):
        chunk, splits = MK.kv_split(b, n)
        assert chunk * splits >= -(-n // MK.BK) > chunk * (splits - 1)


def test_mla_attention_plain_is_softmax_attention():
    """The kernel's plain version in fp32: softmax over each sequence's
    own positions of q [ckv | kpe]^T, times ckv."""
    from repro_torch.kernels import mla_decode as MK
    g = torch.Generator().manual_seed(1)
    q = torch.randn((3, 4, 40), generator=g)
    ckv, kpe = torch.randn((3, 9, 32), generator=g), torch.randn(
        (3, 9, 8), generator=g)
    lens = torch.tensor([7, 1, 5], dtype=torch.int32)
    got = MK.mla_attention(q, ckv, kpe, lens, 0.3, 7)
    for b in range(3):
        n = int(lens[b])
        k = torch.cat([ckv[b, :n], kpe[b, :n]], -1)
        want = torch.softmax(q[b] @ k.T * 0.3, -1) @ ckv[b, :n]
        assert _rel(got[b], want) < 1e-6


def test_decode_past_the_cache_reads_only_the_cache():
    """A free slot's position counts on past the cache (the server's
    rule): the step writes at the last position and attends over the
    cache's length, never past it."""
    cfg = _cfg()
    params = T.init_params(19, cfg, device="cpu")
    toks = torch.as_tensor(np.stack(_prompts(cfg, [6, 6])))
    _, cache = T.prefill(params, {"tokens": toks}, cfg, max_len=8)
    cache["pos"] = torch.tensor([6, 11], dtype=torch.int32)
    logits, cache = T.decode_step(params, cache, torch.tensor([[1], [2]]),
                                  cfg)
    assert bool(torch.isfinite(logits).all())
    assert cache["pos"].tolist() == [7, 12]
