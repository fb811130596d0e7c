"""Port parity for the MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on numpy-seeded inputs, fp32: the router (its
probabilities, top-k sets and aux loss, ties included), the dense path,
the dropping path at a capacity factor that drops tokens (0.5) and one
that drops none (4.0), with the token count not a multiple of the group
size; the training loss's ``nll`` and ``aux`` on the reduced moonshot with
either implementation; and the fp32 leaves ``params_from_jax`` keeps."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

TOL = 1e-5        # x max |ref|, fp32: sums in other orders
D, F_, E, K = 16, 24, 4, 2


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def moe_params():
    jp = JM.init_moe(jax.random.PRNGKey(3), D, F_, E, jnp.float32)
    # a non-trivial norm weight, so the norm is held too
    jp["ln"] = jnp.asarray(np.random.default_rng(4).uniform(
        0.5, 1.5, D).astype(np.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_router_probs_topk_and_aux(moe_params):
    """Random tokens, then a batch with zero tokens, whose probabilities
    tie on every expert: the top-k sets break ties to the lower index, as
    ``jax.lax.top_k`` does."""
    jp, tp = moe_params
    h = _x((2, 9, D), 0)
    h[1, 5:] = 0.0
    jprobs, jidx, jaux = JM._router(jnp.asarray(h), jp, K)
    tprobs, tidx, taux = TM._router(torch.from_numpy(h), tp, K)
    assert tprobs.dtype == torch.float32
    assert _rel(tprobs, jprobs) <= TOL
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))
    np.testing.assert_array_equal(tidx[1, 5:].numpy(),
                                  np.tile(np.arange(K), (4, 1)))


def test_route_log_records_each_router_call(moe_params):
    _, tp = moe_params
    h = torch.from_numpy(_x((3, 5, D), 1))
    TM.route_log = []
    try:
        _, idx, _ = TM._router(h, tp, K)
        logged = TM.route_log
    finally:
        TM.route_log = None
    assert len(logged) == 1 and logged[0].shape == (15, K)
    assert torch.equal(logged[0], idx.reshape(15, K).sort(-1).values)


@pytest.mark.parametrize("impl", ["dense", "dropping"])
def test_route_replay_routes_by_the_given_sets(moe_params, impl):
    """Replaying a call's own expert sets gives its output and aux back;
    replaying other sets (every token to experts 0..K-1) routes by them:
    the output is those experts' outputs weighted by their renormalized
    probabilities (the dropping path at a capacity that drops none)."""
    _, tp = moe_params
    x = torch.from_numpy(_x((2, 9, D), 11))
    run = (lambda: TM.moe_dense(x, tp, K)) if impl == "dense" else (
        lambda: TM.moe_dropping(x, tp, K, 4.0, 16))
    TM.route_log = []
    try:
        want, want_aux = run()
        sets = TM.route_log
        TM.route_log, TM.route_replay = None, [t.clone() for t in sets]
        got, got_aux = run()
        assert TM.route_replay == []
        TM.route_replay = [torch.arange(K).expand(t.shape[0], K)
                           for t in sets]
        forced, _ = run()
    finally:
        TM.route_log = TM.route_replay = None
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)
    h = TM.rmsnorm(x, tp["ln"])
    probs = torch.softmax(torch.matmul(h, tp["router"]), dim=-1)
    weights = torch.zeros_like(probs)
    weights[..., :K] = probs[..., :K] / probs[..., :K].sum(-1, keepdim=True)
    g = torch.nn.functional.silu(torch.einsum("bsd,edf->bsef", h,
                                              tp["w_gate"]))
    u = torch.einsum("bsd,edf->bsef", h, tp["w_up"])
    y = torch.einsum("bsef,efd->bsed", g * u, tp["w_down"])
    expect = x + torch.einsum("bsed,bse->bsd", y, weights)
    assert _rel(forced, expect.numpy()) <= TOL
    assert _rel(want, expect.numpy()) > 1e-3     # its own routing differs


def test_moe_dense_matches_reference(moe_params):
    jp, tp = moe_params
    x = _x((2, 7, D), 2)
    jy, jaux = JM.moe_dense(jnp.asarray(x), jp, K)
    ty, taux = TM.moe_dense(torch.from_numpy(x), tp, K)
    assert _rel(ty, jy) <= TOL
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0],
                         ids=["drops_tokens", "drops_none"])
def test_moe_dropping_matches_reference(moe_params, capacity_factor):
    """38 tokens in groups of 16: three groups, the last padded with 10
    zero tokens.  At 0.5 an expert takes 4 of a group's 16 tokens (32
    routings over 4 experts), so tokens are dropped and the output is not
    the dense one; at 4.0 none is and the output is the dense one."""
    jp, tp = moe_params
    x = _x((2, 19, D), 5)
    jy, jaux = JM.moe_dropping(jnp.asarray(x), jp, K, capacity_factor, 16)
    ty, taux = TM.moe_dropping(torch.from_numpy(x), tp, K, capacity_factor,
                               16)
    assert ty.shape == x.shape
    assert _rel(ty, jy) <= TOL
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))
    dense, _ = TM.moe_dense(torch.from_numpy(x), tp, K)
    if capacity_factor == 4.0:
        assert TM.capacity(16, K, E, capacity_factor) >= 16
        assert _rel(ty, dense.numpy()) <= TOL
    else:
        assert TM.capacity(16, K, E, capacity_factor) == 4
        assert _rel(ty, dense.numpy()) > 1e-2


@pytest.mark.parametrize("impl", ["dense", "dropping"])
def test_loss_nll_and_aux_match_reference(impl):
    """``loss_fn`` on the reduced moonshot (2 layers, 4 experts top-2):
    the NLL and the summed aux loss, and the total that weights it."""
    jc = jax_get_config("moonshot-v1-16b-a3b", reduced=True).with_(
        dtype=jnp.float32, param_dtype=jnp.float32, moe_impl=impl,
        moe_group_size=16)
    tc = get_config("moonshot-v1-16b-a3b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32, moe_impl=impl,
        moe_group_size=16)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(6).integers(0, jc.vocab, (2, 12)).astype(
        np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    jtotal, jm = JT.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)}, jc)
    with torch.no_grad():
        ttotal, tm = TT.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)}, tc)
    assert float(tm["aux"]) > 0
    for got, want in ((ttotal, jtotal), (tm["nll"], jm["nll"]),
                      (tm["aux"], jm["aux"])):
        assert abs(float(got) - float(want)) <= TOL * abs(float(want))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_params_from_jax_keeps_fp32_leaves(arch):
    """bf16 weights from the reference: the router, Mamba's A_log and D,
    mLSTM's wi/wf and sLSTM's gate biases stay fp32, every other leaf is
    bf16, and the port's own init draws the same dtypes."""
    jc = jax_get_config(arch, reduced=True)
    tc = get_config(arch, reduced=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    own = TT.init_params(0, tc, device="cpu")
    fp32 = set()
    for i, (mixer, ffn) in enumerate(tc.layer_kinds()):
        ref = jp["layers"][i % tc.period]
        for part, kind in (("mix", mixer), ("ffn", ffn)):
            for key, leaf in tp["layers"][i].get(part, {}).items():
                want = (torch.float32 if ref[part][key].dtype == jnp.float32
                        else torch.bfloat16)
                assert leaf.dtype == want, (i, part, key)
                assert own["layers"][i][part][key].dtype == want
                if want == torch.float32:
                    fp32.add((kind, key))
    expected = {"moonshot-v1-16b-a3b": {("moe", "router")},
                "xlstm-1.3b": {("mlstm", "wi"), ("mlstm", "wf"),
                               ("slstm", "bi"), ("slstm", "bf"),
                               ("slstm", "bz"), ("slstm", "bo")},
                "jamba-1.5-large-398b": {("moe", "router"),
                                         ("mamba", "A_log"),
                                         ("mamba", "D")}}[arch]
    assert fp32 == expected
