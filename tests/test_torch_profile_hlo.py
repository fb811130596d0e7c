"""The port's ``repro_torch.tools.profile_hlo`` against the reference's
``tools/profile_hlo.py``.

* Against the reference (run in a subprocess at 8 placeholder devices,
  smollm-360m, a train and a decode cell): the argument bytes and the
  step's inputs.  The reference's printed ``parameter`` rows cannot be
  held row for row: XLA names the parameters of every fused computation
  and loop body ``parameter`` too (train_4k prints f32[32,64,4096,960] x6,
  the layer scan's carry, among them), so the test reads the entry
  computation's parameters from the reference's ``--dump`` and holds the
  port's ``parameter`` inputs to them, every one by dims, dtype and
  count.  Two documented differences: the reference stacks the layers of
  a period position into one array for its scan (smollm's 32 layers:
  bf16[32,960,1280] where the port keeps 32 tensors of bf16[960,1280]),
  so the port's layer inputs are stacked here before the comparison; and
  the reference's optimizer state holds its step count as an s32[] (4
  bytes) where the port's Adam keeps a host int, so a train step's
  arguments are 4 bytes fewer in the port, which the test holds exactly
  beside the 1e-3 relative bound.  The decode cell found a fault of
  ``launch.dryrun.memory_estimate``: it built the cache at the per-device
  batch and then cut its batch dim by the data axes again, a quarter of
  the reference's 43.36 GB at this mesh; repaired.
* Without the reference: the tool's ``main`` on a reduced config at 4
  devices prints at most 20 groups, by bytes, honours ``--min-gb``,
  writes ``--dump`` and exits 0 for a train, a prefill and a decode
  shape; its ``parameter`` groups sum to its argument bytes; the record
  leaves ``_count``'s numbers as they are; the CLI runs without jax."""
import collections
import json
import os
import re
import subprocess
import sys

import pytest

from _torch_support import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.dist import sharding as SH
from repro_torch.hw import step_analysis as SA
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.tools import profile_hlo as P
from repro_torch.train import steps as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARGS_RTOL = 1e-3
REF_ARCH, REF_DEVICES = "smollm-360m", 8
# the reference's optimizer step count, an s32[] entry parameter
STEP_COUNT_BYTES = 4
ROW = re.compile(r"^ *([0-9.]+) GB  x *([0-9]+)  (\S+) +(\w+)\[([0-9,]*)\]"
                 r"(/[0-9]+)?$")


def _reference(tmp_path, shape):
    """The reference tool's args bytes and its entry parameters
    [(dtype, dims)], from its stdout and its ``--dump``."""
    dump = tmp_path / f"ref_{shape}.hlo"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_DEVICES=str(REF_DEVICES))
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "profile_hlo.py"),
         "--arch", REF_ARCH, "--shape", shape, "--min-gb", "0.01",
         "--dump", str(dump)], capture_output=True, text=True, timeout=420,
        env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    args_gb = float(re.search(r"args GB: ([0-9.e+-]+)", res.stdout).group(1))
    entry = next(line for line in dump.read_text().splitlines()
                 if line.startswith("ENTRY"))
    inputs = entry[entry.index("(") + 1:entry.index(") ->")]
    assert "(" not in inputs, "tupled entry parameters"
    params = [(dt, tuple(int(d) for d in dims.split(",") if d))
              for dt, dims in re.findall(r":\s*(\w+)\[([0-9,]*)\]", inputs)]
    return args_gb * 1e9, params


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_args_and_inputs_match_reference(tmp_path, shape):
    ref_args, ref_params = _reference(tmp_path, shape)
    cfg = get_config(REF_ARCH)
    cell = SHAPES[shape]
    mesh = make_dryrun_mesh(REF_DEVICES)
    rules = SH.ShardingRules()
    b_loc = SA.local_batch(cfg, cell, mesh, rules)
    args = DR.memory_estimate(cfg, cell, mesh, rules, b_loc, None)[
        "argument_size_in_bytes"]
    gap = STEP_COUNT_BYTES if cell.kind == "train" else 0
    assert abs(args - ref_args) <= ARGS_RTOL * ref_args, (args, ref_args)
    assert abs(args + gap - ref_args) <= 1, (args, gap, ref_args)

    want, layered = collections.Counter(), collections.Counter()
    for role, path, dtype, dims in P.step_inputs(cfg, cell, mesh, rules,
                                                 b_loc, S.TrainConfig()):
        if path[0] == "layers":     # one tensor a layer: stack them
            layered[(role, path[2:], P.dtype_name(dtype), dims)] += 1
        else:
            want[(P.dtype_name(dtype), dims)] += 1
    assert len(cfg.pattern) == 1
    for (_, _, dt, dims), n in layered.items():
        assert n == cfg.n_layers
        want[(dt, (cfg.n_layers,) + dims)] += 1
    if cell.kind == "train":
        want[("s32", ())] += 1
    assert collections.Counter(ref_params) == want


# the reduced cells: each shape's kind at a CPU test's size
REDUCED_SHAPES = {"train_4k": ShapeCell("train_4k", "train", 512, 16),
                  "prefill_32k": ShapeCell("prefill_32k", "prefill", 1024,
                                           8),
                  "decode_32k": ShapeCell("decode_32k", "decode", 1024, 16)}


def _reduced(monkeypatch):
    """The tool on reduced configs and cells at 4 placeholder devices."""
    real = P.get_config
    monkeypatch.setattr(P, "get_config",
                        lambda arch: real(arch, reduced=True))
    monkeypatch.setattr(P, "SHAPES", REDUCED_SHAPES)
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "4")


def _rows(text):
    return [ROW.match(line) for line in text.splitlines()
            if ROW.match(line)]


@pytest.mark.parametrize("shape,min_gb", [("train_4k", 1e-3),
                                          ("prefill_32k", 1e-4),
                                          ("decode_32k", 1e-5)])
def test_main_prints_largest_groups(monkeypatch, capsys, tmp_path, shape,
                                    min_gb):
    """At most 20 groups, by bytes: the largest whose tensors are each at
    least ``--min-gb`` GB (some are not); the dump holds every group.  The
    rows print GB to two places, as the reference's, so they are held
    against the groups of the same cell, profiled again."""
    _reduced(monkeypatch)
    dump = tmp_path / "ops.txt"
    # a first run makes the process's one-off tensors (scalar constants)
    P.profile_cell("moonshot-v1-16b-a3b", shape)
    assert P.main(["--arch", "moonshot-v1-16b-a3b", "--shape", shape,
                   "--min-gb", str(min_gb), "--dump", str(dump)]) == 0
    out = capsys.readouterr().out.splitlines()
    groups = P.profile_cell("moonshot-v1-16b-a3b", shape)["groups"]
    kept = P.largest(groups, min_gb)
    assert 0 < len(kept) <= P.TOP < len(groups)
    assert [v[0] for _, v in kept] == sorted(
        (v[0] for _, v in kept), reverse=True)
    assert all(v[0] / v[1] >= min_gb * 1e9 for _, v in kept)
    assert any(v[0] / v[1] < min_gb * 1e9 for v in groups.values())
    assert out == [P.NOTE] + [P.row(k, *v) for k, v in kept] + [out[-1]]
    assert re.match(r"^temp GB: \S+  args GB: \S+$", out[-1])
    assert dump.read_text().splitlines() == [P.NOTE] + [
        P.row(k, *v) for k, v in P.largest(groups, 0.0, None)]
    assert all(ROW.match(line) for line in out[1:-1])
    assert any(k[0] == "parameter" for k in groups)
    assert any(k[3] > 1 for k in groups)      # a model-axis share


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_parameter_groups_are_the_argument_bytes(monkeypatch, shape):
    _reduced(monkeypatch)
    prof = P.profile_cell("moonshot-v1-16b-a3b", shape)
    params = sum(b for (op, *_), (b, _) in prof["groups"].items()
                 if op == "parameter")
    assert params == prof["args_bytes"]
    assert prof["mesh"] == {"data": 2, "model": 2}
    assert prof["temp_bytes"] > 0


def test_record_leaves_count_unchanged():
    cfg = get_config("qwen2-1.5b", reduced=True)
    cell = ShapeCell("t", "train", 64, 2)
    mesh, rules = {"data": 1, "model": 2}, SH.ShardingRules()
    plain = SA._count(cfg, cell, mesh, rules, {}, 2)
    record = {}
    got = SA._count(cfg, cell, mesh, rules, {}, 2, record=record)
    assert got == plain
    assert record and all(n > 0 and b > 0 for b, n in record.values())
    assert any(f == 2 for (_, _, _, f) in record)


def test_cli_runs_without_jax():
    code = ("import json, runpy, sys\n"
            "sys.argv = ['profile_hlo', '--arch', 'smollm-360m', "
            "'--shape', 'decode_32k']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.tools.profile_hlo', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print(json.dumps({'rc': rc, 'jax': sorted(m for m in "
            "sys.modules if m == 'jax' or m.startswith('jax.'))}))\n")
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="8")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "jax": []}
    assert lines[0] == P.NOTE and lines[-2].startswith("temp GB:")
    assert 0 < len(_rows("\n".join(lines))) <= P.TOP
