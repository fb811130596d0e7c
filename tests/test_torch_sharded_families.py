"""The sharded step builders (``repro_torch.train.steps.build_sharded_*``)
on every family beyond the dense one, on 4 CPU ranks over gloo, mesh
(2, 2), each reduced config in fp32 against the port's unsharded steps on
the same inputs (``tests/_torch_dist.py::sharded_families``): one
``build_sharded_train_step`` step, ``build_sharded_prefill`` and 3
``build_sharded_serve_step`` steps.  moonshot-v1-16b-a3b (MoE, its experts
over the model axis), mixtral-8x22b (window 16 under 24-token prompts:
the sharded ring cache rotates in the prefill and wraps in decode),
jamba-1.5-large-398b (Mamba + attention + MoE), xlstm-1.3b (mLSTM/sLSTM
states), whisper-base (encoder frames, ``xk``/``xv`` caches) and
internvl2-26b (the vision prefix's patches).  The asserts and the
tolerance are ``test_torch_sharded_steps.py``'s: loss, grad norm, the
updated parameters (against the model's largest), prefill and decode
logits at 1e-5, the local shards' shapes and the moments' placements
following the placements.  The unsharded steps are held against the
reference's by ``test_torch_train.py`` and ``test_torch_transformer.py``;
the placements against the reference's by ``test_torch_sharding.py``.

One rule of the reference's optimizer decides which parameter elements
are held: Adam's first update is lr * g / (|g| + eps) with eps 1e-8, so
where |g| is near eps the update follows the gradient's rounding at up to
lr / eps per unit of g.  Such elements occur in every family here: on
moonshot an embedding element's gradient is 2.0e-8 unsharded and 2.6e-8
sharded (a rounding gap of 6e-7 of its row's largest gradient), and its
updates differ by 5% of lr, 5.1e-5 of the model's largest parameter.  The
parameters are therefore held where the unsharded gradient is at least
100 eps (``_torch_dist.ADAM_WELL_POSED``; measured: at most 5.2e-7, on
xlstm), and the gradient everywhere by the grad norm.  Porting this
test found two faults, both repaired: mLSTM/sLSTM's ``F.logsigmoid``,
whose backward DTensor cannot shard (now the reference's -softplus(-x)
as ``logaddexp``), and whisper's cross attention, which ran
``chunked_attention`` on DTensors instead of each rank's heads."""
import pytest

from _torch_dist import FAMILY_ARCHS, run_ranks
from _torch_support import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def results(request, tmp_path_factory):
    return run_ranks("sharded_families", 4,
                     tmp_path_factory.mktemp("families"), timeout=300,
                     arch=request.param)


def test_train_step_matches_unsharded(results):
    for got in results:
        assert got["loss_rel"] <= TOL, got
        assert got["grad_norm_rel"] <= TOL, got
        assert got["param_err_well_posed"] <= TOL, got


def test_local_shards_and_moments_follow_the_placements(results):
    for got in results:
        assert got["shapes_ok"] and got["moments_ok"], got
    assert results[0]["sharded_leaves"] > 0


def test_prefill_and_decode_match_unsharded(results):
    for got in results:
        assert got["prefill_rel"] <= TOL, got
        assert got["decode_rel"] <= TOL, got
