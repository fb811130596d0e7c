"""Which decode steps replay as CUDA graphs
(``repro_torch.models.decode_graphs``), on the CPU: every registered
configuration and a few MLAConfig variants, on CPU and CUDA devices, with
``moe.route_replay`` on and off; a CPU server of each kind decodes
eagerly and counts it; and the graphs' segments, run in order without a
capture, are the eager step at the cache's length, bit for bit, with its
counters and route log.  The capture and its replay run
on the card (``tests/test_torch_moonlight_gpu.py``)."""
import types

import numpy as np
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro_torch import obs
from repro_torch.configs import ARCH_NAMES, PORT_ARCH_NAMES, get_config
from repro_torch.models import decode_graphs as DG
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server

CUDA_TOKENS = types.SimpleNamespace(is_cuda=True)


def _moonlight(**kw):
    return get_config("moonlight-16b-a3b", reduced=True).with_(**kw)


@pytest.mark.parametrize("name", ARCH_NAMES + PORT_ARCH_NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_graphs_support_only_mla_configs_on_cuda(name, reduced):
    cfg = get_config(name, reduced=reduced)
    mla = isinstance(cfg, T.MLAConfig)
    assert mla == (name in ("moonlight-16b-a3b", "kimi-linear-48b-a3b"))
    assert DG.supports(cfg, torch.device("cuda")) == mla
    assert DG.supports(cfg, "cuda:0") == mla
    assert not DG.supports(cfg, "cpu")
    assert not DG.supports(cfg, "meta")


@pytest.mark.parametrize("pattern,first_dense,want", [
    ((("mla", "moe"),), 1, True),       # Moonlight: layer 0 a dense mlp
    ((("mla", "moe"),), 0, True),
    ((("mla", "mlp"),), 0, True),
    ((("mla", "gelu"),), 0, False),
    ((("mla", "none"),), 0, False),
    ((("mla", "moe"), ("attn", "moe")), 1, False),
    ((("mla", "moe"), ("mamba", "none")), 1, False),
    ((("kda", "moe"), ("mla", "moe")), 1, True),    # Kimi Linear's kinds
    ((("kda", "mlp"),), 0, True),
    ((("kda", "gelu"),), 0, False),
])
def test_graphs_support_mla_mixers_with_moe_or_mlp(pattern, first_dense,
                                                   want):
    cfg = _moonlight(pattern=pattern, first_k_dense=first_dense, n_layers=4)
    assert DG.supports(cfg, "cuda") == want


def _graphs(cfg, supported):
    params = T.init_params(0, cfg, device="cpu")
    g = DG.DecodeGraphs(params, cfg, T.init_cache(cfg, 2, 16, device="cpu"))
    assert not g.supported
    g.supported = supported      # as on a CUDA device
    return g


@pytest.mark.parametrize("supported", [True, False])
def test_route_replay_turns_the_graphs_off(supported, monkeypatch):
    g = _graphs(_moonlight(), supported)
    assert g.engages(CUDA_TOKENS) == supported
    assert not g.engages(torch.zeros((2, 1), dtype=torch.int32))
    monkeypatch.setattr(MOE, "route_replay", [torch.zeros((2, 2))])
    assert not g.engages(CUDA_TOKENS)
    monkeypatch.setattr(MOE, "route_replay", [])
    assert not g.engages(CUDA_TOKENS)
    assert g.captures == 0


class _Refuse:
    """A graph state that must not be stepped."""

    def engages(self, tokens):
        return True

    def step(self, *args):
        raise AssertionError("replayed where the eager step was asked for")


@pytest.mark.parametrize("kw", [{"kv_len": 16}, {"use_kernel": False}])
def test_an_explicit_kv_len_or_plain_path_runs_eagerly(kw):
    cfg = _moonlight(dtype=torch.float32, param_dtype=torch.float32)
    params = T.init_params(1, cfg, device="cpu")
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    tracer = obs.Tracer()
    with obs.use(tracer):
        logits, _ = T.decode_step(params, cache, torch.tensor([[1], [2]]),
                                  cfg, graphs=_Refuse(), **kw)
    counters = tracer.metrics.snapshot()["counters"]
    assert counters["decode.eager_steps"] == 1
    assert "decode.graph_replays" not in counters
    assert logits.shape == (2, cfg.vocab)


@pytest.mark.parametrize("name", ["moonlight-16b-a3b", "qwen2-1.5b",
                                  "mixtral-8x22b", "xlstm-1.3b"])
def test_cpu_servers_decode_eagerly_and_count_it(name):
    cfg = get_config(name, reduced=True).with_(dtype=torch.float32,
                                               param_dtype=torch.float32)
    params = T.init_params(2, cfg, device="cpu")
    server = Server(params, cfg, n_slots=2, max_len=32)
    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 9)):
        server.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, n).astype(np.int32), max_new_tokens=4))
    tracer = obs.Tracer()
    with obs.use(tracer):
        done = server.run_until_drained()
    assert len(done) == 2 and all(len(r.output) == 4 for r in done)
    counters = tracer.metrics.snapshot()["counters"]
    # the prefill gives each request its first token, three steps the rest
    assert counters["decode.eager_steps"] == 3
    assert "decode.graph_replays" not in counters
    assert server.graphs.captures == 0 and server.graphs._graphs is None


def _clone(cache):
    return {"pos": cache["pos"].clone(),
            "layers": [{k: t.clone() for k, t in e.items()}
                       for e in cache["layers"]]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_segments_in_order_are_the_eager_step_at_the_cache_length(dtype):
    """Prefilled slots at different depths; three steps of the graphs'
    segments, built once and run eagerly in order as the capture runs
    them (one ``io`` dict across steps, ``pos`` advanced in place),
    against ``decode_step(kv_len=max_len)`` on a copy of the cache: the
    same logits and cache, bit for bit, and the same counters and route
    log."""
    cfg = _moonlight(dtype=dtype, param_dtype=dtype)
    params = T.init_params(4, cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)))
    _, cache = T.prefill(params, {"tokens": toks}, cfg, max_len=24)
    cache["pos"] = torch.tensor([9, 4], dtype=torch.int32)
    want_cache = _clone(cache)
    g = DG.DecodeGraphs(params, cfg, cache)
    segs = g._segments()
    assert [n for n, _ in segs] == ([None] + ["mla", "mlp"]
                                    + ["mla", "moe"] * (cfg.n_layers - 1)
                                    + [None])
    got_t, want_t = obs.Tracer(), obs.Tracer()
    for step in range(3):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)),
                                 dtype=torch.int32)
        MOE.route_log = []
        try:
            with obs.use(want_t):
                want, want_cache = T.decode_step(params, want_cache, tokens,
                                                 cfg, kv_len=24)
            want_routes = MOE.route_log
            MOE.route_log = []
            g._io["tokens"] = tokens
            with obs.use(got_t):
                for _, fn in segs:
                    fn()
            got_routes = MOE.route_log
        finally:
            MOE.route_log = None
        g.pos.add_(1)
        assert torch.equal(g._io["logits"], want)
        assert torch.equal(g.pos, want_cache["pos"])
        for e, w in zip(g.layers, want_cache["layers"]):
            assert all(torch.equal(e[k], w[k]) for k in e)
        assert len(got_routes) == len(want_routes) == cfg.n_layers - 1
        assert all(torch.equal(a, b) for a, b in zip(got_routes,
                                                     want_routes))
    got, want = (t.metrics.snapshot()["counters"] for t in (got_t, want_t))
    assert sorted(got) == sorted(want) == [
        "mla.cache_tokens", "moe.experts_touched", "moe.tokens_dropped"]
    assert all(float(got[k]) == float(want[k]) for k in got)


def test_kimi_segments_are_the_eager_step_at_the_cache_length():
    """Kimi Linear's reduced stack (KDA and MLA layers, the expert share):
    a ``kda`` segment and an FFN segment a KDA layer, ``mla`` and FFN an
    MLA layer; two steps of the segments run in order against
    ``decode_step(kv_len=max_len)`` on a copy of the cache: the same
    logits and cache (KDA's state and conv tails too), bit for bit, and
    the same counters, the pairs routed off the chip among them."""
    cfg = get_config("kimi-linear-48b-a3b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    params = T.init_params(6, cfg, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)))
    _, cache = T.prefill(params, {"tokens": toks}, cfg, max_len=24)
    want_cache = _clone(cache)
    g = DG.DecodeGraphs(params, cfg, cache)
    segs = g._segments()
    assert [n for n, _ in segs] == (
        [None] + [x for m, f in cfg.layer_kinds() for x in (m, f)] + [None])
    got_t, want_t = obs.Tracer(), obs.Tracer()
    for _ in range(2):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)),
                                 dtype=torch.int32)
        with obs.use(want_t):
            want, want_cache = T.decode_step(params, want_cache, tokens, cfg,
                                             kv_len=24)
        g._io["tokens"] = tokens
        with obs.use(got_t):
            for _, fn in segs:
                fn()
        g.pos.add_(1)
        assert torch.equal(g._io["logits"], want)
        for e, w in zip(g.layers, want_cache["layers"]):
            assert all(torch.equal(e[k], w[k]) for k in e)
    got, want = (t.metrics.snapshot()["counters"] for t in (got_t, want_t))
    assert sorted(got) == sorted(want) == [
        "mla.cache_tokens", "moe.experts_touched", "moe.pairs_elsewhere",
        "moe.tokens_dropped"]
    assert all(float(got[k]) == float(want[k]) for k in got)


def test_warm_up_leaves_kda_state_as_it_was():
    """The capture's warm-up run of every segment: each KDA layer's state
    and conv tails as before it (a replay advances them once), the MLA
    layers' rows at the slots' positions written (the replay writes the
    same values)."""
    cfg = get_config("kimi-linear-48b-a3b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    params = T.init_params(8, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 9)))
    _, cache = T.prefill(params, {"tokens": toks}, cfg, max_len=24)
    before = _clone(cache)
    g = DG.DecodeGraphs(params, cfg, cache)
    g._io["tokens"] = torch.tensor([[3], [4]], dtype=torch.int32)
    g._warm(g._segments())
    for (mixer, _), e, w in zip(cfg.layer_kinds(), g.layers,
                                before["layers"]):
        if mixer == "kda":
            assert all(torch.equal(e[k], w[k]) for k in e)
        else:
            assert not torch.equal(e["ckv"][:, 9], w["ckv"][:, 9])
            assert torch.equal(e["ckv"][:, :9], w["ckv"][:, :9])
    assert torch.equal(g.pos, before["pos"])
