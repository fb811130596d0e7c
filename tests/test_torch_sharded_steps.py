"""The sharded step builders (``repro_torch.train.steps.build_sharded_*``)
on 4 CPU ranks over gloo, reduced qwen2-1.5b in fp32, against the port's
unsharded steps on the same inputs: meshes (2, 2), (4, 1) and (1, 4) (the
last shards ``wk``/``wv`` mid-head), FSDP with its threshold lowered for
the reduced sizes, sequence parallelism, and two microbatches
(``grad_accum`` 2, the fp32 sum).  The unsharded steps are
held against the reference's by ``test_torch_train.py`` and
``test_torch_transformer.py``; the reference's own sharded step fails in
its sharded ``jax.jit`` (``ShardingTypeError`` on the embedding gather),
so its rules are held here (``test_torch_sharding.py`` holds the
placements), not its run.

An updated parameter's error is taken against the largest parameter of
the model, not of its own leaf: ``bk``'s gradient is zero in exact
arithmetic (a key bias shifts every score of a query alike, which softmax
ignores), so Adam's first step turns its rounding noise into an update
of the order of lr in both paths."""
import pytest

from _torch_dist import SHARDED_CASES, run_ranks
from _torch_support import one_torch_thread  # noqa: F401

TOL = 1e-5
CASES = [name for name, *_ in SHARDED_CASES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ranks = run_ranks("sharded_steps", 4, tmp_path_factory.mktemp("sharded"),
                      timeout=300)
    return ranks


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_unsharded(results, case):
    for rank in results:
        got = rank[case]
        assert got["loss_rel"] <= TOL, got
        assert got["grad_norm_rel"] <= TOL, got
        assert got["param_err"] <= TOL, got


@pytest.mark.parametrize("case", CASES)
def test_local_shards_and_moments_follow_the_placements(results, case):
    for rank in results:
        got = rank[case]
        assert got["shapes_ok"] and got["moments_ok"], got
    # every mesh but (4, 1) (data parallel alone) splits some leaves
    assert (results[0][case]["sharded_leaves"] > 0) == (case != "4x1")


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_unsharded(results, case):
    for rank in results:
        got = rank[case]
        assert got["prefill_rel"] <= TOL, got
        assert got["decode_rel"] <= TOL, got
