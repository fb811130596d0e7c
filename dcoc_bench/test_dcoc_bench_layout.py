"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by that name."""
import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from dcoc_bench import harness  # noqa: E402
from dcoc_bench.reference.networks import conv_layers  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
E2E = {m["name"] for m in BENCH["end_to_end"]}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(CELLS) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_full_check_fits_with_24_cells():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1200 s spare: within 43,200 s with the full 24 cells."""
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_are_unique_and_plain():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entry(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    e2e = metric in E2E
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in E2E
    for cell in m.get("workloads", []):
        assert cell in CELLS
        if not e2e:
            reported = {x["name"] for x in harness.cell_metrics(
                BENCH, cell, per_layer=False)}
            assert m["moves"] in reported
    # the reader is found by the name, and reads a number or nothing
    if metric != "setup_s":
        assert callable(harness.reader(metric).read)


def test_metrics_of_one_layer_name_it_alike():
    for m in BENCH["per_layer"]:
        stem = m["name"].split(".")[0]
        same = {x["layer"] for x in BENCH["per_layer"]
                if x["name"].split(".")[0] == stem}
        assert len(same) == 1, stem


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and line(entry["why"])
    run = harness.make_run(cell, 1, 1.0, False, device="cpu", bench=BENCH)
    assert run.workload["config"] == entry["config"]
    assert run.workload["traffic"] == entry["traffic"]
    assert run.workload["chips"] == entry["chips"]
    gen = harness.generator(run.mix["kind"])
    for fn in ("setup", "window", "trace", "check"):
        assert callable(getattr(gen, fn))
    assert run.workload["limits"] and all(
        v >= 0 for v in run.workload["limits"].values())
    e2e = harness.cell_metrics(BENCH, cell, per_layer=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, cell, per_layer=True)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_entry_and_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"dcoc_bench/configs/{config}.json"
    assert line(entry["source"]) and line(entry["why"])
    assert entry["source"].startswith("https://")
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert config in {w["config"] for w in BENCH["workloads"]}
    # every key in reduced is in the file, and none is a width
    for key in entry["reduced"]:
        assert key in cfg
        assert not key.endswith(("_dim", "_rank", "_size"))


@pytest.mark.parametrize("cell", [c for c in CELLS if "deploy" in c])
def test_tuning_record_covers_every_conv(cell):
    run = harness.make_run(cell, 1, 1.0, False, device="cpu", bench=BENCH)
    path = run.config["tuned"][str(run.mix["batch"])]
    assert any(path.startswith(p + "/") for p in BENCH["paths"])
    with open(os.path.join(ROOT, path)) as f:
        record = json.load(f)
    assert record["batch"] == run.mix["batch"]
    layers = [x for t in record["tasks"] for x in t["layers"]]
    assert sorted(layers) == sorted(c.name for c in conv_layers(run.config))
    for t in record["tasks"]:
        assert set(t["knobs"]) == {"tile_b", "tile_ci", "tile_co",
                                   "h_threading", "oc_threading", "tile_h",
                                   "tile_w"}
