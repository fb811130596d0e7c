"""Kimi-Linear-48B-A3B's new paths on the card: the KDA decode kernel
against its plain version at the cell's shape (256 slots of 32 heads)
and at odd batches, and its refusals; the MLA decode kernel at 32 heads
against its plain version, each group of 16 heads bit for bit the kernel
at 16 heads on that group's queries; and the reduced block at the
kernels' widths served through ``Server``, its decode steps replayed as
CUDA graphs against eager steps at the cache's length, bit for bit, with
their counters and launches.  Every test carries the ``gpu`` marker and
skips where torch sees no CUDA device.  No JAX:

    python -m pytest -q -m gpu tests/test_torch_kimi_gpu.py
"""
import numpy as np
import pytest
import torch

import _lm_workloads as W
from _torch_support import require_cuda
from repro_torch import obs
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h", W.KDA_CASES)
def test_kda_decode_kernel_matches_plain_on_card(b, h):
    """One launch on ``b`` slots of ``h`` heads: the output and the state
    it leaves within 1e-5 of max of the plain step's (fp32 sums in
    another order)."""
    require_cuda()
    from repro_torch.kernels import kda_decode as KK
    g = torch.Generator(device="cuda").manual_seed(b)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    q, k, v = rnd(b, h, 128), rnd(b, h, 128), rnd(b, h, 128)
    gate = -2 * torch.rand((b, h, 128), generator=g, device="cuda")
    beta = torch.rand((b, h), generator=g, device="cuda")
    state = rnd(b, h, 128, 128)
    want_state = state.clone()
    n0 = KK.kda_recurrence.launches
    got = KK.kda_recurrence(q, k, v, gate, beta, state, 128 ** -0.5)
    torch.cuda.synchronize()
    assert KK.kda_recurrence.launches == n0 + 1
    want = KK.kda_recurrence_plain(q, k, v, gate, beta, want_state,
                                   128 ** -0.5)
    assert _rel(got, want) < 1e-5
    assert _rel(state, want_state) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case,why", [("bfloat16", "float32"),
                                      ("width", "heads of 128"),
                                      ("strided", "contiguous")])
def test_kda_decode_kernel_refuses_what_it_cannot_take_on_card(case, why):
    require_cuda()
    from repro_torch.kernels import kda_decode as KK
    b, h = 2, 3
    d = 64 if case == "width" else 128
    dt = torch.bfloat16 if case == "bfloat16" else torch.float32
    q = torch.randn((b, h, d), device="cuda")
    state = torch.randn((b, h, d, 2 * d if case == "strided" else d),
                        device="cuda", dtype=dt)
    if case == "strided":
        state = state[..., ::2]
    beta = torch.rand((b, h), device="cuda")
    n0 = KK.kda_recurrence.launches
    with pytest.raises(ValueError, match=why):
        KK.kda_recurrence(q, q, q, -q.abs(), beta, state, 0.1)
    assert KK.kda_recurrence.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("b,lo,hi,cap", [(256, 1024, 2176, 8192),
                                         (5, 1, 40, 47)])
def test_mla_decode_kernel_at_32_heads_on_card(b, lo, hi, cap):
    """At 32 heads (two groups of 16 a sequence, side by side on the
    grid): within 1e-2 of max of the plain version, and each group bit
    for bit the kernel at 16 heads on that group's queries (the same
    split, the same blocks' work)."""
    require_cuda()
    from repro_torch.kernels import mla_decode as MK
    g = torch.Generator(device="cuda").manual_seed(b)
    q = torch.randn((b, 32, 576), generator=g, device="cuda").bfloat16()
    ckv = torch.randn((b, cap, 512), generator=g, device="cuda").bfloat16()
    kpe = torch.randn((b, cap, 64), generator=g, device="cuda").bfloat16()
    lens = torch.randint(lo, hi + 1, (b,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[-1] = hi, lo
    got = MK.mla_attention(q, ckv, kpe, lens, 192 ** -0.5, cap)
    want = MK.mla_attention_plain(q, ckv, kpe, lens, 192 ** -0.5, cap)
    assert got.shape == (b, 32, 512) and _rel(got, want) < 1e-2
    for half in (slice(0, 16), slice(16, 32)):
        alone = MK.mla_attention(q[:, half].contiguous(), ckv, kpe, lens,
                                 192 ** -0.5, cap)
        assert torch.equal(got[:, half], alone)


@pytest.mark.gpu
def test_graph_steps_match_eager_steps_on_card():
    """The reduced block at the kernels' widths, bf16: two servers on the
    same weights and requests (prompts of 70 and 130 tokens: KDA's chunks,
    the second short), stepped in turn for 8 steps, one replaying its
    CUDA graphs, one eager at ``kv_len`` = ``max_len``: the same logits
    bit for bit, the same route log, counters (no held pair dropped, the
    pairs routed off the chip counted alike) and kernel launches; every
    step replayed, one capture."""
    require_cuda()
    from repro_torch.kernels import kda_decode as KK
    from repro_torch.kernels import mla_decode as MK
    cfg = W.kimi_card_config(torch.bfloat16)
    params = T.init_params(17, cfg, device="cuda")
    max_len = 512
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (70, 130)]
    servers = [Server(params, cfg, n_slots=2, max_len=max_len)
               for _ in range(2)]
    for server in servers:
        for i, p in enumerate(prompts):
            server.submit(Request(uid=i, prompt=p, max_new_tokens=64))
    real = T.decode_step

    def eager(params, cache, tokens, cfg, graphs=None):
        return real(params, cache, tokens, cfg, kv_len=max_len)

    logits, logs = [[], []], [[], []]
    tracers = [obs.Tracer(), obs.Tracer()]
    launches = [[0, 0], [0, 0]]
    for _ in range(8):
        for k, server in enumerate(servers):
            n0 = (MK.mla_attention.launches, KK.kda_recurrence.launches)
            MOE.route_log = logs[k]
            if k == 1:
                T.decode_step = eager
            try:
                with obs.use(tracers[k]):
                    server.step()
            finally:
                MOE.route_log = None
                T.decode_step = real
            launches[k][0] += MK.mla_attention.launches - n0[0]
            launches[k][1] += KK.kda_recurrence.launches - n0[1]
            logits[k].append(server.last_logits.clone())
    for a, b in zip(*logits):
        assert torch.equal(a, b)
    assert len(logs[0]) == len(logs[1]) and all(
        torch.equal(a, b) for a, b in zip(*logs))
    counters = [t.metrics.snapshot()["counters"] for t in tracers]
    for name in ("moe.experts_touched", "moe.tokens_dropped",
                 "moe.pairs_elsewhere", "mla.cache_tokens"):
        assert float(counters[0][name]) == float(counters[1][name]), name
    assert float(counters[0]["moe.tokens_dropped"]) == 0
    assert float(counters[0]["moe.pairs_elsewhere"]) > 0
    assert counters[0]["decode.graph_replays"] == 8
    assert servers[0].graphs.captures == 1
    kinds = [m for m, _ in cfg.layer_kinds()]
    assert launches[0] == launches[1] == [8 * kinds.count("mla"),
                                          8 * kinds.count("kda")]
