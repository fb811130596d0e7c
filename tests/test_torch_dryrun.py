"""The port's dry-run estimator (``repro_torch.launch.dryrun``,
``repro_torch.hw.step_analysis``) against the reference's
``repro.launch.dryrun``.

* The artifact's keys and status on the reference's ``test_dryrun`` cells
  (8 placeholder devices: a 4 x 2 mesh, batch 8): qwen2-1.5b train_4k,
  whisper-base decode_32k, xlstm-1.3b long_500k (ok: sub-quadratic),
  qwen2-1.5b long_500k (skipped), smollm on the multi-pod mesh.
* Each ShardSpace knob moves the artifact the reference's way: FSDP adds
  all-gather bytes, remat raises a train step's dot FLOPs, a model axis of
  1 has no tensor-parallel all-reduce (only the gradients'), and
  ``moment_dtype`` changes only the modelled HBM residency.
* The counted dot FLOPs are ``FlopCounterMode``'s of one real step (a
  reduced model on the CPU), exactly, where the model axis is 1.
* On qwen2-1.5b train_4k the per-device dot FLOPs are held against the
  reference's artifact (its compiled HLO, parsed; run in a subprocess
  with 8 placeholder devices) within 1e-3 relative.  The measured gap was
  below 1e-6 (PERF.md); collective bytes are a model and are not held."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_support import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.dist import sharding as SH
from repro_torch.hw import step_analysis as SA
from repro_torch.launch import dryrun as DR
from repro_torch.launch.autotune import compile_and_analyze

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
REF_FLOPS_RTOL = 1e-3
KEYS = {"arch", "shape", "mesh", "mesh_desc", "kind", "status",
        "compile_s", "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "weighted", "param_bytes_global"}
WEIGHTED = {"dot_flops_per_device", "collective_bytes_by_op",
            "wire_bytes_per_device"}


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", "train_4k"),
    ("whisper-base", "decode_32k"),
    ("xlstm-1.3b", "long_500k"),
])
def test_dryrun_cell_artifact(tmp_path, arch, shape):
    art = DR.run_cell(arch, shape, False, str(tmp_path), batch_override=8,
                      n_devices=8)
    files = os.listdir(tmp_path)
    assert files == [f"{arch}__{shape}__pod_16x16.json"]
    on_disk = json.load(open(tmp_path / files[0]))
    assert on_disk["status"] == art["status"] == "ok", art.get("error")
    assert KEYS <= set(on_disk) and WEIGHTED <= set(on_disk["weighted"])
    assert on_disk["mesh_desc"] == "data=4 x model=2"
    assert on_disk["weighted"]["dot_flops_per_device"] > 0
    assert on_disk["temp_size_in_bytes"] > 0
    assert on_disk["argument_size_in_bytes"] > 0
    assert on_disk["param_bytes_global"] > on_disk["argument_size_in_bytes"] \
        / 8


def test_dryrun_long_context_skip_and_multipod(tmp_path):
    art = DR.run_cell("qwen2-1.5b", "long_500k", False, str(tmp_path),
                      n_devices=8)
    assert art["status"] == "skipped" and "full-attention" in art["reason"]
    art = DR.run_cell("smollm-360m", "train_4k", True, None,
                      batch_override=8, n_devices=8)
    assert art["status"] == "ok" and "pod=2" in art["mesh_desc"]


def test_dryrun_main_exit_codes(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                 "--devices", "8", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert "skipped" in capsys.readouterr().out


def _analyze(arch, shape, mesh, **kw):
    cfg = get_config(arch)
    if "remat" in kw:
        cfg = cfg.with_(remat=kw.pop("remat"))
    return SA.analyze(cfg, SHAPES[shape], mesh, **kw)


def test_knobs_move_the_artifact_the_reference_way():
    mesh = {"data": 64, "model": 4}
    off = _analyze("qwen2-1.5b", "train_4k", mesh)
    on = _analyze("qwen2-1.5b", "train_4k", mesh,
                  rules=SH.ShardingRules(fsdp_weights=True))
    assert off["collective_bytes_by_op"].get("all-gather", 0.0) == 0.0
    assert on["collective_bytes_by_op"]["all-gather"] > 0.0
    assert on["weighted_dot_flops"] == off["weighted_dot_flops"]
    remat = _analyze("qwen2-1.5b", "train_4k", mesh, remat=True)
    plain = _analyze("qwen2-1.5b", "train_4k", mesh, remat=False)
    assert remat["weighted_dot_flops"] > 1.2 * plain["weighted_dot_flops"]
    # a model axis of 1: the gradients' all-reduce over the data axes is
    # the only collective, one a parameter leaf, of its bf16 bytes
    cfg = get_config("qwen2-1.5b")
    one = _analyze("qwen2-1.5b", "train_4k", {"data": 256, "model": 1})
    assert set(one["collective_bytes_by_op"]) == {"all-reduce"}
    ab = SA.T.abstract_params(cfg)
    assert one["collective_bytes_by_op"]["all-reduce"] == sum(
        t.numel() * t.element_size() for t in SH.tree_leaves(ab))
    assert one["collective_counts"]["all-reduce"] == len(SH.tree_leaves(ab))
    # moment dtype: the modelled residency only
    base = dict(model_axis=16, fsdp=True, grad_accum=1, remat=True,
                attn_chunk=1024, sequence_parallel=False)
    bf = compile_and_analyze("qwen2-1.5b", "train_4k",
                             dict(base, moment_dtype="bfloat16"),
                             verbose=False, n_devices=256)
    f32 = compile_and_analyze("qwen2-1.5b", "train_4k",
                              dict(base, moment_dtype="float32"),
                              verbose=False, n_devices=256)
    assert f32["hbm_residency_gib"] > bf["hbm_residency_gib"]
    for k in ("compute_s", "memory_s", "collective_s", "hlo_flops"):
        assert f32[k] == bf[k], k


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b", "whisper-base"])
def test_dot_flops_are_flopcountermode_of_one_real_step(arch):
    """Model axis 1: the estimator's count (1 and 2 periods carried to the
    depth; xlstm's 2-4 tokens carried to its 4 chunks) equals
    FlopCounterMode around one real training step on the CPU."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    cfg = get_config(arch, reduced=True).with_(n_layers=2 * len(
        get_config(arch, reduced=True).pattern))
    seq = 32 if arch == "xlstm-1.3b" else 64
    est = SA.analyze(cfg, ShapeCell("t", "train", seq, 2),
                     {"data": 1, "model": 1})
    params = T.init_params(0, cfg, device="cpu")
    tc = S.TrainConfig()
    opt = S.make_optimizer(tc, params)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=2, seed=0)).batch_at(0)
    if cfg.enc_dec:
        batch["frames"] = np.zeros((2, cfg.enc_seq, cfg.d_model),
                                   np.float32)
    with FlopCounterMode(display=False) as fc:
        S.train_step_fn(cfg, tc)(params, opt, batch)
    assert est["weighted_dot_flops"] == fc.get_total_flops()


def test_dot_flops_match_reference_artifact(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "qwen2-1.5b",
         "--shape", "train_4k", "--mesh", "pod", "--batch", "8", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=420,
        env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = json.load(open(tmp_path / os.listdir(tmp_path)[0]))
    art = DR.run_cell("qwen2-1.5b", "train_4k", False, None,
                      batch_override=8, n_devices=8)
    assert art["mesh_desc"] == ref["mesh_desc"]
    want = ref["weighted"]["dot_flops_per_device"]
    got = art["weighted"]["dot_flops_per_device"]
    assert abs(got - want) <= REF_FLOPS_RTOL * want, (got, want)
    assert art["param_bytes_global"] == ref["param_bytes_global"]
