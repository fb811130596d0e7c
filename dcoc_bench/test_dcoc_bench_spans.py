"""The readers of the tuner's spans on hand-made span lists whose self
times are known: a span's self time leaves out its direct children on its
own lane, and nothing on another lane."""
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from dcoc_bench import harness, spans  # noqa: E402

MAIN, LANE = "MainThread", "mappo-episode"
# (name, start, end, depth, lane) of one session of 10 s
SESSION = [
    ("session", 0.0, 10.0, 0, MAIN),
    ("task-init", 0.0, 0.25, 1, MAIN),
    ("seed-draw", 0.25, 0.5, 1, MAIN),
    ("forest-export", 1.0, 1.125, 1, MAIN),
    ("mappo-update", 1.125, 6.0, 1, MAIN),
    ("mappo-rollout", 1.25, 4.0, 2, LANE),
    ("mappo-ppo", 4.0, 5.75, 2, LANE),
    ("pool-dedup", 6.0, 6.25, 1, MAIN),
    ("critic-score", 6.25, 6.375, 1, MAIN),
    ("confidence-sampling", 6.375, 6.5, 1, MAIN),
    ("measure", 6.5, 6.625, 1, MAIN),
    ("measure-wait", 7.0, 7.0625, 1, MAIN),
    ("records", 7.0625, 7.125, 1, MAIN),
    ("surrogate-refit", 7.125, 9.5, 1, MAIN),
]
# what no child on the session's lane covers: 0.5-1.0, 6.625-7.0, 9.5-10
UNTRACED = 0.5 + 0.375 + 0.5
EXPECT = {"rollout_s": 2.75, "ppo_s": 1.75, "export_s": 0.125,
          "select_s": 0.25 + 0.125 + 0.125, "untraced_s": UNTRACED,
          "mappo_s": 6.0 - 1.125}
NEW = ("rollout_s", "ppo_s", "export_s", "select_s", "untraced_s")


def span_list(rows, sessions=2, period=20.0):
    return [{"name": n, "t": t0 + k * period, "dur": t1 - t0, "depth": d,
             "tid": tid, "cat": "", "ph": "X"}
            for k in range(sessions) for n, t0, t1, d, tid in rows]


def fake_run(span_rows, sessions=2):
    return types.SimpleNamespace(obs={
        "spans": span_list(span_rows, sessions) if span_rows else None,
        "sessions": [{}] * sessions})


@pytest.mark.parametrize("metric", sorted(EXPECT))
def test_reader_reads_self_seconds_a_session(metric):
    got = harness.reader(metric).read(fake_run(SESSION))
    assert got == pytest.approx(EXPECT[metric], abs=1e-12)


def test_a_span_on_another_lane_leaves_its_parent_whole():
    rows = span_list(SESSION, sessions=1)
    # the episode spans lie inside mappo-update, one level down
    assert spans.self_seconds(rows, "mappo-update") == pytest.approx(4.875)
    moved = [dict(r, tid=MAIN) if r["tid"] == LANE else r for r in rows]
    assert spans.self_seconds(moved, "mappo-update") == pytest.approx(0.375)


def test_self_times_on_the_sessions_lane_add_up_to_the_session():
    rows = span_list(SESSION, sessions=1)
    main = sum(spans.self_seconds(rows, n)
               for n, _, _, _, tid in SESSION if tid == MAIN)
    assert main == pytest.approx(10.0)


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_nothing_without_spans(metric):
    assert harness.reader(metric).read(fake_run(None)) is None


@pytest.mark.parametrize("metric", ["rollout_s", "ppo_s", "export_s",
                                    "select_s"])
def test_reader_reads_nothing_where_the_program_lacks_its_spans(metric):
    older = [r for r in SESSION if r[0] in (
        "session", "seed-draw", "mappo-update", "measure", "measure-wait",
        "surrogate-refit")]
    assert harness.reader(metric).read(fake_run(older)) is None


def test_select_s_sums_the_spans_it_finds():
    rows = [r for r in SESSION if r[0] != "critic-score"]
    got = harness.reader("select_s").read(fake_run(rows))
    assert got == pytest.approx(0.25 + 0.125)
