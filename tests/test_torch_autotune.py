"""The port's pod-level compile oracle and shard-space autotuner
(``CompileOracle``, ``TuningTask.cell``, ``repro_torch.launch.autotune``,
the CLI's ``tune --arch/--shape/--oracle compile``) against the
reference's ``repro.compiler.task.TuningTask.cell`` / ``ShardSpace``.

The space a cell is tuned over is the reference's, exactly (knob tables,
agent partition, workload, cell descriptor).  A measurement row is the
reference's record: ``step_penalized_s`` as the latency, the
``SettingsOracle._RESULT_KEYS`` under ``result``, finite.  The session
runs end to end through the CLI on the CPU, and refuses to run without a
GPU unless asked for the CPU."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_support import one_torch_thread  # noqa: F401
from repro.compiler.task import TuningTask as JTask
from repro_torch.compiler.oracle import CompileOracle, SettingsOracle
from repro_torch.compiler.records import RecordLog
from repro_torch.compiler.task import TuningTask
from repro_torch.launch.autotune import compile_and_analyze

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.mark.parametrize("arch,shape,n", [
    ("qwen2-1.5b", "train_4k", 256), ("mixtral-8x22b", "decode_32k", 256),
    ("xlstm-1.3b", "long_500k", 8), ("whisper-base", "prefill_32k", 64)])
def test_cell_space_is_the_reference_space(arch, shape, n):
    got = TuningTask.cell(arch, shape, n_devices=n)
    want = JTask.cell(arch, shape, n_devices=n)
    assert got.name == want.name
    g, w = got.space, want.space
    assert g.knob_names == w.knob_names
    assert g.choices == w.choices
    assert g.agent_knobs == w.agent_knobs
    assert g.workload == w.workload
    assert g.cell_features == w.cell_features
    np.testing.assert_allclose(g.workload_features(), w.workload_features(),
                               rtol=1e-6)


def test_cell_refuses_too_few_devices():
    with pytest.raises(ValueError, match="model-axis"):
        TuningTask.cell("qwen2-1.5b", "train_4k", n_devices=2)


def test_compile_oracle_rows_carry_result_keys(tmp_path):
    task = TuningTask.cell("qwen2-1.5b", "train_4k", n_devices=256,
                           verbose=False)
    records = RecordLog(str(tmp_path / "r.jsonl"))
    oracle = task.make_oracle(records)
    assert isinstance(oracle, CompileOracle) and oracle.n_devices == 256
    configs = np.asarray([[2, 0, 1, 0, 1, 2, 0], [0, 1, 0, 1, 0, 0, 1]])
    lat, feats = oracle.measure(configs)
    assert np.all(np.isfinite(lat)) and feats.shape == (2, 18)
    rows = records.load(task=task.name)
    assert len(rows) == 2
    for row in rows:
        assert set(SettingsOracle._RESULT_KEYS) <= set(row["result"])
        assert all(math.isfinite(float(row["result"][k]))
                   for k in ("step_s", "compile_s", "hbm_residency_gib"))
        assert row["result"]["dominant"] in ("compute", "memory",
                                             "collective")
    direct = compile_and_analyze("qwen2-1.5b", "train_4k",
                                 rows[0]["settings"], verbose=False,
                                 n_devices=256)
    assert lat[0] == direct["step_penalized_s"]
    assert oracle.worker_spec.factory == \
        "repro_torch.compiler.oracle:_compile_measure_factory"
    assert "--xla_force_host_platform_device_count=256" in \
        oracle.worker_spec.env["XLA_FLAGS"]


def test_compile_oracle_measures_in_a_worker():
    """``workers=1``: the measurement runs in a spawned worker built from
    the oracle's WorkerSpec, and gives the in-process value."""
    task = TuningTask.cell("qwen2-1.5b", "decode_32k", n_devices=16,
                           verbose=False)
    pooled = task.make_oracle(workers=1, timeout_s=240)
    try:
        lat, _ = pooled.measure(np.asarray([[1, 0, 1, 0, 0, 0, 0]]))
    finally:
        pooled.close()
    local, _ = task.make_oracle().measure(
        np.asarray([[1, 0, 1, 0, 0, 0, 0]]))
    assert pooled.failures == 0 and lat[0] == local[0]


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.compiler.cli",
                           "tune", *args], capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_cli_tune_compile_oracle_on_cpu(tmp_path):
    out = tmp_path / "tune.json"
    res = _cli("--arch", "qwen2-1.5b", "--shape", "train_4k", "--oracle",
               "compile", "--budget", "4", "--device", "cpu", "--out",
               str(out))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rep = json.load(open(out))["reports"]["qwen2-1.5b/train_4k"]
    assert rep["n_measurements"] == 4
    assert math.isfinite(rep["best_latency"])
    assert set(rep["best_settings"]) == {
        "model_axis", "moment_dtype", "fsdp", "grad_accum", "remat",
        "attn_chunk", "sequence_parallel"}


def test_cli_tune_refuses_without_gpu_or_cpu_request():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    res = _cli("--arch", "qwen2-1.5b", "--oracle", "compile", "--budget",
               "4")
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    res = _cli("--arch", "qwen2-1.5b", "--budget", "4", "--device", "cpu")
    assert res.returncode != 0 and "--oracle compile" in res.stderr
