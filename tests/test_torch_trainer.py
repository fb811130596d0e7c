"""The port's fault-tolerant ``Trainer`` held to the rules of the
reference's two trainer tests (``tests/test_distributed.py``: loss falls
and survives an injected crash and NaN; a restart resumes from the final
checkpoint), on the CPU, on one device and over a (2, 1) mesh of two
gloo ranks, and the training launcher in a subprocess (under
``torch.distributed.run`` for a mesh)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_support import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.checkpoint import available_steps
from repro_torch.train.steps import TrainConfig
from repro_torch.train.trainer import FailureInjector, Trainer, TrainerConfig

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def test_trainer_loss_decreases_and_survives_faults(tmp_path):
    cfg = get_config("smollm-360m", reduced=True)
    tc = TrainConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    trc = TrainerConfig(steps=40, ckpt_dir=str(tmp_path), ckpt_every=10,
                        log_every=5)
    injector = FailureInjector(crash_at=17, nan_at=26)
    tr = Trainer(cfg, tc, trc, device="cpu",
                 data_cfg=DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=4, structure=16),
                 injector=injector)
    log = tr.run()
    assert tr.step == 40
    assert injector.fired == ["crash@17", "nan@26"]   # both faults triggered
    rollbacks = [e for e in log if "event" in e]
    assert [e["step"] for e in rollbacks] == [10, 20]  # both recovered
    losses = [(e["step"], e["loss"]) for e in log if "loss" in e]
    first = np.mean([l for s, l in losses[:2]])
    last = np.mean([l for s, l in losses[-2:]])
    assert last < first, (first, last)       # still learning after recovery
    assert all(np.isfinite(l) for _, l in losses)
    # the replay after a rollback retraces the same steps exactly
    by_step = {}
    for s, l in losses:
        by_step.setdefault(s, []).append(l)
    assert by_step[10] == [by_step[10][0]] * 2 and len(by_step[20]) == 2


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    cfg = get_config("qwen2-1.5b", reduced=True)
    tc = TrainConfig(lr=5e-4, warmup_steps=2, total_steps=30)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, structure=8)
    trc = TrainerConfig(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5)
    first = Trainer(cfg, tc, trc, device="cpu", data_cfg=dc)
    first.run()
    # process "restarts": a new Trainer picks up from the final checkpoint
    trc2 = TrainerConfig(steps=16, ckpt_dir=str(tmp_path), ckpt_every=5)
    tr2 = Trainer(cfg, tc, trc2, device="cpu", data_cfg=dc)
    assert tr2.step == 10                    # resumed, not reinitialized
    assert tr2.opt.step_count == 10
    for a, b in zip(tr2.opt.params + tr2.opt.mu + tr2.opt.nu,
                    first.opt.params + first.opt.mu + first.opt.nu):
        assert torch.equal(a.detach(), b.detach())
    tr2.run()
    assert tr2.step == 16


def test_trainer_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen2-1.5b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(), TrainerConfig(ckpt_dir=str(tmp_path)))


def _launch(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=timeout)


def test_launcher_trains_on_cpu_and_prints_the_report(tmp_path):
    out = _launch("--arch", "qwen2-1.5b", "--reduced", "--steps", "4",
                  "--batch", "2", "--seq", "32", "--device", "cpu",
                  "--ckpt", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "arch=qwen2-1.5b" in out.stdout and "device=cpu" in out.stdout
    rep = json.loads(out.stdout[out.stdout.index("{"):])
    assert set(rep) == {"first_loss", "last_loss", "steps", "wall_s",
                        "tokens_per_s"}
    assert rep["steps"] == 4 and np.isfinite(rep["last_loss"])
    assert available_steps(str(tmp_path)) == [0, 4]   # anchor and final


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Both trainer setups on a (2, 1) mesh, in one spawn of 2 ranks."""
    return run_ranks("mesh_trainer", 2, tmp_path_factory.mktemp("mesh"),
                     timeout=300)


def test_mesh_trainer_loss_decreases_and_survives_faults(mesh_run):
    for rank in mesh_run:
        got = rank["faults"]
        assert got["step"] == 40
        assert got["fired"] == ["crash@17", "nan@26"]
        rollbacks = [e for e in got["log"] if "event" in e]
        assert [e["step"] for e in rollbacks] == [10, 20]
        losses = [(e["step"], e["loss"]) for e in got["log"] if "loss" in e]
        first = np.mean([l for _, l in losses[:2]])
        last = np.mean([l for _, l in losses[-2:]])
        assert last < first, (first, last)
        assert all(np.isfinite(l) for _, l in losses)
        by_step = {}
        for step, l in losses:
            by_step.setdefault(step, []).append(l)
        assert by_step[10] == [by_step[10][0]] * 2 and len(by_step[20]) == 2
    # every rank logs the same global losses
    logs = [[{k: v for k, v in e.items() if k != "sec"}
             for e in rank["faults"]["log"]] for rank in mesh_run]
    assert logs[0] == logs[1]


def test_mesh_trainer_restart_resumes_from_checkpoint(mesh_run):
    for rank in mesh_run:
        got = rank["restart"]
        assert got["step"] == 10 and got["opt_step"] == 10
        assert got["equal"]      # parameters and moments, shard by shard
        assert got["final_step"] == 16


def test_launcher_trains_over_a_mesh_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "qwen2-1.5b", "--reduced", "--steps", "4", "--batch", "2",
         "--seq", "32", "--data", "2", "--model", "1", "--device", "cpu",
         "--ckpt", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("arch=qwen2-1.5b") == 1      # rank 0 alone
    assert "mesh=data=2 x model=1" in out.stdout
    rep = json.loads(out.stdout[out.stdout.index("{"):])
    assert rep["steps"] == 4 and np.isfinite(rep["last_loss"])
    assert available_steps(str(tmp_path)) == [0, 4]


def test_launcher_refuses_a_mesh_and_a_missing_card(tmp_path):
    out = _launch("--reduced", "--steps", "1", "--device", "cpu", "--data",
                  "2", "--ckpt", str(tmp_path))
    assert out.returncode != 0
    assert "needs 2 processes, the world size is 1" in out.stderr
    if not torch.cuda.is_available():
        out = _launch("--reduced", "--steps", "1", "--ckpt", str(tmp_path))
        assert out.returncode != 0 and "no CUDA device" in out.stderr
