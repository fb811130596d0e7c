"""The port's examples (``python -m repro_torch.examples.<name>``) run
end to end on the CPU through their ``main(argv)``, each at small
settings, with the reference example's own checks."""
import json
import os

import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.examples import (arco_sharding_search, quickstart, serve_lm,
                                  train_lm, tune_resnet18)
from repro_torch.hw.analytical import conv2d_min_latency


def test_quickstart_deploys_within_tolerance_above_the_bound(capsys):
    out = quickstart.main(["--device", "cpu"])
    # step 4: the tuned geometry's conv agrees with the plain oracle
    assert out["deploy_max_abs_err"] <= 1e-4 * out["oracle_max_abs"]
    assert out["gemm_launches"] == 0        # CPU tensors: the plain version
    floor = conv2d_min_latency(quickstart.WORKLOAD)
    assert floor == out["min_latency_s"]
    for name in ("arco", "autotvm", "random"):
        assert out[f"{name}_latency_s"] >= floor, name
    text = capsys.readouterr().out
    assert "design space: " in text and "roofline lower bound" in text
    assert "max |err| vs oracle" in text


@pytest.mark.parametrize("entry,argv", [
    (quickstart, []), (serve_lm, []), (train_lm, []), (tune_resnet18, []),
    (arco_sharding_search, ["--arch", "qwen2-1.5b", "--budget", "2"])])
def test_examples_default_to_cuda_and_raise_without_it(entry, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(argv)


def test_tune_resnet18_software_only(capsys):
    out = tune_resnet18.main(["--budget", "2", "--device", "cpu"])
    assert set(out["network_latency_s"]) == {"arco", "autotvm", "chameleon"}
    assert all(v > 0 for v in out["network_latency_s"].values())
    text = capsys.readouterr().out
    assert "ResNet-18: 17 conv layers, 8 unique tuning tasks" in text
    assert "throughput vs AutoTVM*" in text


def test_tune_resnet18_coopt_replays_records_with_no_measurement(tmp_path,
                                                                 capsys):
    argv = ["--coopt", "--seed-candidates", "2", "--hw-rounds", "0",
            "--hw-per-round", "1", "--layer-budget", "2",
            "--refine-budget", "0", "--budget", "64",
            "--records", str(tmp_path / "r"), "--device", "cpu"]
    first = tune_resnet18.main(argv)
    assert first["coopt"].total_measurements > 0
    assert first["coopt"].verify_shared_hardware()
    assert (first["coopt"].network_latency
            <= first["frozen"].network_latency)
    again = tune_resnet18.main(argv)
    assert again["coopt"].total_measurements == 0
    assert again["frozen"].total_measurements == 0
    assert sum(r.oracle_stats["misses"] for r in again["fantasy"]) == 0
    assert again["coopt"].network_latency == first["coopt"].network_latency
    assert "shared hardware config identical" in capsys.readouterr().out


def test_tune_resnet18_trace_and_monitor(tmp_path, capsys):
    trace = str(tmp_path / "run.trace.json")
    tune_resnet18.main(["--budget", "2", "--device", "cpu", "--trace",
                        trace, "--monitor", "0"])
    text = capsys.readouterr().out
    assert os.path.getsize(trace) > 0
    assert f"trace written to {trace}" in text
    assert "live monitor at http://127.0.0.1:" in text
    with pytest.raises(SystemExit):     # transfer needs the co-optimizer
        tune_resnet18.main(["--budget", "2", "--device", "cpu",
                            "--warm-from", str(tmp_path / "none.jsonl")])


def test_serve_lm_serves_every_request(capsys):
    out = serve_lm.main(["--requests", "5", "--slots", "2", "--max-new",
                         "4", "--device", "cpu"])
    assert [r.uid for r in out["done"]] == list(range(5))
    assert all(r.ok and len(r.output) == 4 for r in out["done"])
    assert out["tokens"] == 20
    assert out["rejected"] == out["abandoned"] == 0
    assert "5 requests, 20 tokens" in capsys.readouterr().out


def test_train_lm_loss_falls():
    out = train_lm.main(["--steps", "20", "--batch", "4", "--seq", "64",
                         "--device", "cpu"])
    assert out["steps"] == 20
    assert out["last_loss"] < out["first_loss"]


def test_arco_sharding_search_delegates_to_autotune(tmp_path, capsys):
    out = str(tmp_path / "search.json")
    arco_sharding_search.main(["--arch", "qwen2-1.5b", "--shape",
                               "train_4k", "--budget", "2", "--devices",
                               "256", "--out", out, "--device", "cpu"])
    with open(out) as f:
        summary = json.load(f)
    assert summary["arch"] == "qwen2-1.5b" and summary["shape"] == "train_4k"
    assert summary["n_measurements"] == 2
    text = capsys.readouterr().out      # measure lines, then the summary
    assert json.loads(text[text.index('{\n "arch"'):]) == summary
