"""The spans of an ARCO session: every second of ``Session.run`` under a
named span, each MAPPO episode split into its rollout and its PPO update
on a lane of its own, and the tuner's results unmoved by tracing."""
import pytest

from _torch_support import one_torch_thread  # noqa: F401
from repro_torch import obs
from repro_torch.compiler.session import Session
from repro_torch.compiler.task import TuningTask
from repro_torch.core import mappo
from repro_torch.core.tuner import TunerConfig

FAST = TunerConfig.fast()
BUDGET = FAST.iteration_opt * FAST.b_measure
NEW = ("forest-export", "mappo-rollout", "mappo-ppo", "pool-dedup",
       "critic-score", "confidence-sampling", "records", "task-init")


def _session(tracer=None):
    tasks = TuningTask.conv_tasks("resnet-18")[:2]
    with obs.use(tracer):
        rep = Session(tasks, tuner=FAST, budget=BUDGET, seed=3,
                      device="cpu").run()
    return {r.task: (list(r.best_config), float(r.best_latency))
            for r in rep}


@pytest.fixture(scope="module")
def traced():
    tracer = obs.Tracer(name="test")
    reports = _session(tracer)
    return reports, tracer.spans()


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _inside(c, s):
    return (c["t"] >= s["t"] and c["t"] + c["dur"] <= s["t"] + s["dur"])


def _children(spans, s):
    """Direct children of ``s`` on its own lane."""
    return [c for c in spans if c["tid"] == s["tid"]
            and c["depth"] == s["depth"] + 1 and _inside(c, s)]


def test_every_new_span_is_recorded(traced):
    _, spans = traced
    names = {s["name"] for s in spans}
    assert set(NEW) | {"session", "seed-draw", "mappo-update", "measure",
                       "measure-wait", "surrogate-refit"} <= names
    assert len(_named(spans, "task-init")) == 2


def test_episodes_split_on_their_own_lane(traced):
    _, spans = traced
    updates = _named(spans, "mappo-update")
    n_episodes = len(updates) * FAST.episodes_per_iter
    assert updates and all(u["tid"] != mappo.EPISODE_LANE for u in updates)
    keys = {}
    for name in ("mappo-rollout", "mappo-ppo"):
        found = _named(spans, name)
        assert len(found) == n_episodes
        assert all(s["tid"] == mappo.EPISODE_LANE for s in found)
        # each inside one mappo-update, of its task and iteration
        for s in found:
            (u,) = [u for u in updates if _inside(s, u)]
            assert (s["args"]["task"], s["args"]["it"]) == (
                u["args"]["task"], u["args"]["it"])
        keys[name] = sorted((s["args"]["task"], s["args"]["it"],
                             s["args"]["episode"]) for s in found)
    assert keys["mappo-rollout"] == keys["mappo-ppo"]
    assert len(set(keys["mappo-rollout"])) == n_episodes
    assert {k[2] for k in keys["mappo-rollout"]} == set(
        range(FAST.episodes_per_iter))


def test_mappo_update_holds_only_the_episodes(traced):
    _, spans = traced
    updates = _named(spans, "mappo-update")
    (session,) = _named(spans, "session")
    for u in updates:
        assert _children(spans, u) == []
    for name in ("forest-export", "pool-dedup", "critic-score",
                 "confidence-sampling"):
        found = _named(spans, name)
        assert len(found) == len(updates)
        for s in found:
            assert not any(_inside(s, u) for u in updates)
            assert s["tid"] == session["tid"]
            assert s["depth"] == session["depth"] + 1


def test_session_time_is_nearly_all_under_child_spans(traced):
    _, spans = traced
    (session,) = _named(spans, "session")
    covered = sum(c["dur"] for c in _children(spans, session))
    assert session["dur"] - covered < 0.1 * session["dur"]


def test_tracing_leaves_the_reports_unchanged(traced):
    reports, _ = traced
    assert _session() == reports
