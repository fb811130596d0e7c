"""Moonlight-16B-A3B's new paths on the card: the flash kernel's bf16
dp=192 template on MLA's prefill shapes against attention in fp32
(values zero-padded from 128), the grouped MoE (``torch._grouped_mm``)
against every expert on every token, the absorbed decode against the
expanded form, the MLA decode kernel against its plain version (and
its refusal of CUDA operands it is not built for), one
MLA + MoE layer and layer 0 at published widths served through
``Server`` (its decode steps replayed as CUDA graphs) against the plain
float32 reference (``dcoc_bench/reference/deepseek_v3.py``), and the
replayed steps against eager ones (bit for bit at the cache's length),
with their counters, route log and launch counts, across a request that
finishes and one admitted into its slot, and around a step that
``moe.route_replay`` makes eager.  Every test carries the
``gpu`` marker and skips where torch sees no CUDA device.  No JAX:

    python -m pytest -q -m gpu tests/test_torch_moonlight_gpu.py
"""
import contextlib
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_support import require_cuda
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _two_layers(dtype=torch.bfloat16):
    """Layer 0 (dense) and one MLA + MoE layer at published widths, the
    whole vocabulary."""
    return get_config("moonlight-16b-a3b").with_(
        n_layers=2, dtype=dtype, param_dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [100, 4096])
def test_flash_dp192_matches_attention_on_card(s):
    """bf16 q, k (B, S, 16, 192) and v (B, S, 16, 128) zero-padded to
    192: the kernel's first 128 columns against causal softmax attention
    in fp32 on the same bf16 inputs (P and the output rounded to bf16 in
    the kernel: 1e-2 of max), its last 64 zero."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(s)
    q, k = (torch.randn((1, s, 16, 192), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    v = torch.randn((1, s, 16, 128), generator=g, device="cuda").bfloat16()
    launches = TF.flash_attention.launches
    got = TF.flash_attention(q, k, F.pad(v, (0, 64)))
    torch.cuda.synchronize()
    assert TF.flash_attention.launches == launches + 1
    assert TF.flash_attention.last_geometry["run"]["dp"] == 192
    want = F.scaled_dot_product_attention(
        q.float().transpose(1, 2), k.float().transpose(1, 2),
        v.float().transpose(1, 2), is_causal=True).transpose(1, 2)
    assert _rel(got[..., :128], want) < 1e-2
    assert got[..., 128:].abs().max() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [64, 3000])
def test_grouped_moe_matches_dense_on_card(tokens):
    """The published MoE layer, bf16: ``grouped`` (``torch._grouped_mm``)
    against every expert on every token weighted by the same routing."""
    require_cuda()
    cfg = _two_layers()
    params = T.init_params(1, cfg, device="cuda")
    p = params["layers"][1]["ffn"]
    x = torch.randn((1, tokens, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2)
                    ).bfloat16()
    got, _ = MOE.moe_block(x, p, cfg)
    if tokens > 1000:   # dense: every expert on every token, in slices
        want = torch.cat([MOE.moe_block(x[:, i:i + 500], p, cfg.with_(
            moe_impl="dense"))[0] for i in range(0, tokens, 500)], 1)
    else:
        want, _ = MOE.moe_block(x, p, cfg.with_(moe_impl="dense"))
    assert _rel(got - x, want - x) < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)], ids=str)
def test_absorbed_decode_matches_expanded_on_card(dtype, tol):
    """Published widths: a decode step (absorbed, on the latent cache)
    against the prefill of the same tokens (expanded; fp32 on the plain
    attention, as the fp32 flash kernel stops at head_dim 128)."""
    require_cuda()
    cfg = _two_layers(dtype)
    params = T.init_params(3, cfg, device="cuda")
    plain = dtype == torch.float32
    toks = torch.randint(0, cfg.vocab, (2, 300), device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(4))
    _, cache = T.prefill(params, {"tokens": toks[:, :-1]}, cfg, 512,
                         use_kernel=not plain)
    got, _ = T.decode_step(params, cache, toks[:, -1:], cfg,
                           use_kernel=not plain)
    want, _ = T.prefill(params, {"tokens": toks}, cfg, 512,
                        use_kernel=not plain)
    assert _rel(got, want) < tol


@pytest.mark.gpu
def test_layers_serve_against_reference_on_card():
    """Layer 0 and one MLA + MoE layer, bf16, published widths, served:
    two slots of 4,000 and 2,500 prompt tokens prefilled, then 8 decode
    steps; every step's logits against the float32 reference's full
    forward over prompt and outputs, the program's expert sets replayed.
    Prints the readings."""
    require_cuda()
    from dcoc_bench.reference import deepseek_v3 as REF
    from dcoc_bench.harness import BENCH_DIR, load_json
    hf = dict(load_json(BENCH_DIR, "configs", "moonlight-16b-a3b.json"),
              num_hidden_layers=2)
    cfg = _two_layers()
    params = T.init_params(5, cfg, device="cuda")
    server = Server(params, cfg, n_slots=2, max_len=8192)
    rng = np.random.default_rng(6)
    reqs = [server.submit(Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, n).astype(np.int32), max_new_tokens=64))
            for i, n in enumerate((4000, 2500))]
    MOE.route_log = []
    try:
        steps, logits = [], []
        for _ in range(9):
            server.step()
            steps.append(list(MOE.route_log))
            MOE.route_log.clear()
            logits.append(server.last_logits.float().cpu())
    finally:
        MOE.route_log = None
    prefill, steps[0] = steps[0][:2], steps[0][2:]
    slot = {r.uid: s for s, r in server.active.items()}
    seqs, at, routes = [], [], []
    for r, req in enumerate(reqs):
        s = slot[r]
        seqs.append(torch.as_tensor(list(req.prompt) + req.output[:9]))
        at.append([len(req.prompt) + j for j in range(9)])
        routes.append([torch.cat([prefill[r]] + [steps[j][0][s:s + 1]
                                                 for j in range(9)])])
    with torch.no_grad():
        ref = REF.forward(hf, params, seqs, at, routes=routes)
    gaps = [_rel(logits[j][slot[r]], ref["logits"][r][j].cpu())
            for r in range(2) for j in range(9)]
    share = ref["route_mismatch"] / ref["route_tokens"]
    print(f"[moonlight layers] logit_gap max {max(gaps):.4e} "
          f"mean {np.mean(gaps):.4e}; route_gap {share:.4e} "
          f"({ref['route_mismatch']} of {ref['route_tokens']})")
    assert max(gaps) < 5e-2 and share < 0.1
    assert server.graphs.captures == 1     # the decode steps replayed


@contextlib.contextmanager
def _eager(kv_len):
    """``transformer.decode_step`` as ``Server.step`` calls it, run
    eagerly, at ``kv_len`` (None: its default, the longest slot's)."""
    real = T.decode_step

    def eager(params, cache, tokens, cfg, graphs=None):
        return real(params, cache, tokens, cfg, kv_len=kv_len)

    T.decode_step = eager
    try:
        yield
    finally:
        T.decode_step = real


def _lockstep(servers, modes, steps, on_step=None):
    """``steps`` steps of each server in turn, ``modes[k]`` the
    ``_eager`` kv_len of server k or "graph"; each under a tracer and a
    route log of its own.  Returns per server: the logits of every step,
    the route log, the tracer's counters, the MLA kernel's launches.
    ``on_step(j, k)``: a context for step j of server k."""
    from repro_torch.kernels import mla_decode as MK
    n = len(servers)
    logits, logs = [[] for _ in range(n)], [[] for _ in range(n)]
    tracers, launches = [obs.Tracer() for _ in range(n)], [0] * n
    for j in range(steps):
        for k, (server, mode) in enumerate(zip(servers, modes)):
            n0 = MK.mla_attention.launches
            MOE.route_log = logs[k]
            try:
                with obs.use(tracers[k]), \
                        (contextlib.nullcontext() if mode == "graph"
                         else _eager(mode)), \
                        (on_step(j, k) if on_step
                         else contextlib.nullcontext()):
                    server.step()
            finally:
                MOE.route_log = None
            launches[k] += MK.mla_attention.launches - n0
            logits[k].append(server.last_logits.clone())
    return logits, logs, [t.metrics.snapshot()["counters"] for t in tracers], \
        launches


def _traced_launches(fn) -> dict:
    """The MLA decode kernel's, its combine's and RMSNorm's launches in
    one call of ``fn``, as ``torch.profiler`` traces them on the card (a
    CUDA graph's kernels one by one)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
            for k in ("mla_decode_kernel", "mla_decode_combine_kernel",
                      "rmsnorm_kernel")}


@pytest.mark.gpu
def test_graph_steps_match_eager_steps_on_card():
    """Layer 0 and one MLA + MoE layer, bf16, published widths: three
    servers on the same weights and requests, stepped in turn for 20
    steps: one replaying its CUDA graphs, one eager at ``kv_len`` =
    ``max_len`` (the same kernels and MLA split: bit for bit, which the
    graphs keep, cuBLAS choosing by shape alone), one eager at the
    default ``kv_len`` (another MLA split: within 1e-2 of max).
    Slots of 3,000 and 1,200 prompt tokens; the second finishes after 6
    tokens and a 2,000-token request is admitted into its slot, with no
    new capture.  The counters, route log and MLA launches of the graph
    server equal the eager one's; every decode step replayed.  Then one
    more step of each under ``torch.profiler``: the replay launches the
    MLA decode kernel, its combine and RMSNorm as often as the eager
    step (2, 2, 7), which the launch counts the replay adds agree with."""
    require_cuda()
    cfg = _two_layers()
    params = T.init_params(7, cfg, device="cuda")
    max_len = 4096
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (3000, 1200, 2000)]
    servers = [Server(params, cfg, n_slots=2, max_len=max_len)
               for _ in range(3)]
    reqs = [[server.submit(Request(uid=i, prompt=p, max_new_tokens=new))
             for i, (p, new) in enumerate(zip(prompts, (64, 6, 64)))]
            for server in servers]
    logits, logs, counters, launches = _lockstep(
        servers, ("graph", max_len, None), 20)
    graph, eager, default = servers
    for j in range(20):
        assert torch.equal(logits[0][j], logits[1][j]), j
        assert _rel(logits[0][j], logits[2][j]) < 1e-2, j
    assert [r.output for r in reqs[0]] == [r.output for r in reqs[1]]
    assert reqs[0][1].status == "done"
    assert sorted(r.uid for r in graph.active.values()) == [0, 2]
    assert graph.graphs.captures == 1
    assert eager.graphs.captures == default.graphs.captures == 0
    assert len(logs[0]) == len(logs[1]) and all(
        torch.equal(a, b) for a, b in zip(logs[0], logs[1]))
    for name in ("moe.experts_touched", "moe.tokens_dropped",
                 "mla.cache_tokens"):
        assert float(counters[0][name]) == float(counters[1][name]), name
    assert float(counters[0]["moe.tokens_dropped"]) == 0
    assert counters[0]["decode.graph_replays"] == 20
    assert "decode.eager_steps" not in counters[0]
    assert launches[0] == launches[1] == launches[2] == 20 * cfg.n_layers
    traced = [_traced_launches(graph.step)]
    with _eager(max_len):
        traced.append(_traced_launches(eager.step))
    assert graph.graphs.captures == 1 and eager.graphs.captures == 0
    assert traced[0] == traced[1] == {
        "mla_decode_kernel": cfg.n_layers,
        "mla_decode_combine_kernel": cfg.n_layers,    # 2 slots: a split
        "rmsnorm_kernel": 3 * cfg.n_layers + 1}


@pytest.mark.gpu
def test_route_replay_step_runs_eagerly_between_replays_on_card():
    """A graph server and an eager one (``kv_len`` = ``max_len``) stepped
    in turn; at step 3 the graph server replays the eager one's expert
    sets (``moe.route_replay``), so that step runs eagerly and makes a new
    ``pos``; the next steps replay again from it, with no new capture,
    within the bf16 tolerance of the eager server."""
    require_cuda()
    cfg = _two_layers()
    params = T.init_params(9, cfg, device="cuda")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (2500, 1800)]
    eager, graph = servers = [Server(params, cfg, n_slots=2, max_len=4096)
                              for _ in range(2)]
    for server in servers:
        for i, p in enumerate(prompts):
            server.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    replay = {}

    @contextlib.contextmanager
    def at_step_3(j, k):
        if j != 3:
            yield
        elif k == 0:                  # the eager server goes first
            yield
            replay["routes"] = list(MOE.route_log[-(cfg.n_layers - 1):])
        else:
            MOE.route_replay = [t.clone() for t in replay["routes"]]
            try:
                yield
            finally:
                MOE.route_replay = None

    logits, _, counters, _ = _lockstep(servers, (4096, "graph"), 8,
                                       at_step_3)
    for j in range(8):
        assert _rel(logits[1][j], logits[0][j]) < 5e-2, j
    assert counters[1]["decode.graph_replays"] == 7
    assert counters[1]["decode.eager_steps"] == 1
    assert graph.graphs.captures == 1
    assert graph.cache["pos"] is graph.graphs.pos
    assert torch.equal(graph.cache["pos"], eager.cache["pos"])


@pytest.mark.gpu
@pytest.mark.parametrize("b,lo,hi,cap", [
    (64, 1, 4610, 4617), (3, 1, 40, 47), (600, 1, 100, 107),
    (64, 2048, 4096, 8192), (600, 1, 100, 100)])
def test_mla_decode_kernel_matches_plain_on_card(b, lo, hi, cap):
    """The MLA decode kernel (split over the cache where the batch leaves
    the card's blocks idle: 9 splits at 64 slots; none at 600 x 100) on
    ``b`` sequences of ``lo`` to ``hi`` positions in a ``cap``-position
    cache, among them the benchmark's 64 conversations at 2,048-4,096
    positions of 8,192: at ``kv_len`` = ``hi`` one launch within 1e-2 of
    max of its plain version on the same bf16 inputs (P rounded against
    the running max in the kernel, the final one in the plain version);
    at ``kv_len`` = ``cap``, as a captured decode step calls it, the same
    split count, and each sequence's blocks share its own length, so the
    same bits."""
    require_cuda()
    from repro_torch.kernels import mla_decode as MK
    g = torch.Generator(device="cuda").manual_seed(b)
    q = torch.randn((b, 16, 576), generator=g, device="cuda").bfloat16()
    ckv = torch.randn((b, cap, 512), generator=g, device="cuda").bfloat16()
    kpe = torch.randn((b, cap, 64), generator=g, device="cuda").bfloat16()
    lens = torch.randint(lo, hi + 1, (b,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[-1] = hi, lo
    launches = MK.mla_attention.launches
    got = MK.mla_attention(q, ckv, kpe, lens, 192 ** -0.5, hi)
    torch.cuda.synchronize()
    assert MK.mla_attention.launches == launches + 1
    want = MK.mla_attention_plain(q, ckv, kpe, lens, 192 ** -0.5, hi)
    assert _rel(got, want) < 1e-2
    if lo == 1:   # a sequence of one position is its own row of ckv
        assert _rel(got[-1], ckv[-1, :1].expand(16, 512)) < 1e-2
    assert MK.kv_split(b, cap)[1] == MK.kv_split(b, hi)[1]
    assert torch.equal(MK.mla_attention(q, ckv, kpe, lens, 192 ** -0.5, cap),
                       got)


@pytest.mark.gpu
@pytest.mark.parametrize("case,why", [("float32", "bfloat16"),
                                      ("widths", "built for"),
                                      ("strided", "contiguous")])
def test_mla_decode_kernel_refuses_what_it_cannot_take_on_card(case, why):
    """CUDA operands the kernel is not built for (fp32, other widths, a
    strided cache) raise and name why, launching nothing; with
    ``use_kernel=False`` the plain version runs them."""
    require_cuda()
    from repro_torch.kernels import mla_decode as MK
    b, c = 2, 40
    dt = torch.float32 if case == "float32" else torch.bfloat16
    r = 32 if case == "widths" else 512
    q = torch.randn((b, 16, r + 64), device="cuda", dtype=dt)
    ckv = torch.randn((b, 2 * c, r), device="cuda", dtype=dt)
    ckv = ckv[:, ::2] if case == "strided" else ckv[:, :c].contiguous()
    kpe = torch.randn((b, c, 64), device="cuda", dtype=dt)
    lens = torch.full((b,), c, dtype=torch.int32, device="cuda")
    launches = MK.mla_attention.launches
    with pytest.raises(ValueError, match=why):
        MK.mla_attention(q, ckv, kpe, lens, 0.1, c)
    assert MK.mla_attention.launches == launches
    got = MK.mla_attention(q, ckv, kpe, lens, 0.1, c, use_kernel=False)
    assert got.shape == (b, 16, r) and bool(torch.isfinite(got).all())
