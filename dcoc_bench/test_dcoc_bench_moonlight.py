"""The ``moonlight.decode-b64`` cell at a tiny size on the CPU: it comes
out correct through ``harness.run_local``, and each planted fault
(``serve_decode.FAULTS``) does not; its configuration file is the
program's registered config; its reference loads no kernel of the
program and no JAX; its readers and the decode roofline."""
import json
import os
import subprocess
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from dcoc_bench import harness, roofline_lm  # noqa: E402

CELL = "moonlight.decode-b64"
# the published block at a width the CPU runs in seconds
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=32,
            intermediate_size=96, n_routed_experts=8, num_experts_per_tok=2,
            vocab_size=512, dtype="float32")
MIX = dict(slots=4, max_len=512, prompt_min=8, prompt_max=24, warmup_steps=2,
           traced_steps=2, checked_slots=2, checked_steps=2, check_span=6)
SEED = 2 ** 31 + 12345


def _run(fault=None):
    import contextlib
    gen = harness.generator("serve_decode")
    with gen.planted(fault) if fault else contextlib.nullcontext():
        return harness.run_local(CELL, SEED, 0.2, mix_overrides=MIX,
                                 config_overrides=TINY)


def test_tiny_cell_is_correct():
    run, res = _run()
    assert res["correct"] is True
    assert res["checks"]["drop_gap"]["value"] == 0
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["checks"]["route_gap"]["value"] == 0
    assert res["metrics"]["fwd_p95_ms"]["value"] > 0
    assert res["detail"]["finished"] == 0
    assert res["attempted"] == res["detail"]["steps"] * MIX["slots"]
    # every sampled step's logits were kept before the window, whose steps
    # ran with the route log off
    from repro_torch.models import moe as MOE
    assert len(run.state["captured"]) == MIX["checked_slots"] * 2
    assert MOE.route_log is None
    assert len(run.state["step_routes"]) == 1 + max(
        max(js) for js in run.state["picks"].values())
    # the dispatch of every step before the window was counted
    assert run.state["dropped"] == 0
    lat, enq = run.obs["latencies"], run.obs["enqueue_s"]
    assert len(enq) == len(lat) and all(0 < e <= t for e, t in zip(enq, lat))


@pytest.mark.parametrize("fault", ["bias_ignored", "no_scaling",
                                   "shared_skipped", "decode_not_absorbed"])
def test_planted_faults_are_not_correct(fault):
    _, res = _run(fault)
    assert res["correct"] is False


@pytest.mark.parametrize("quant,caught", [("bf16", False), ("fp8", True)])
def test_control_one_precision_down(quant, caught):
    """The reference in the program's place: rounded to bf16 (the
    configuration's precision) it stays inside the limits; to fp8 (one
    below) it fails them."""
    gen = harness.generator("serve_decode")
    run = harness.make_run(CELL, SEED, 0.2, False, device="cpu",
                           mix_overrides=MIX, config_overrides=TINY)
    harness.execute(run, 0.0)
    checks = gen.control_checks(run, run.state["params"], quant)
    limits = run.workload["limits"]
    assert any(checks[k] > limits[k] for k in checks) is caught


def test_config_file_is_the_registered_config():
    from repro_torch.configs import get_config
    gen = harness.generator("serve_decode")
    cfg = harness.load_json(harness.BENCH_DIR, "configs",
                            "moonlight-16b-a3b.json")
    assert gen.arch_config(cfg) == get_config("moonlight-16b-a3b")
    bad = dict(cfg, topk_method="greedy")
    with pytest.raises(ValueError):
        gen.arch_config(bad)


def test_config_file_holds_the_catalog_numbers():
    cfg = harness.load_json(harness.BENCH_DIR, "configs",
                            "moonlight-16b-a3b.json")
    assert cfg["reduced"] == [] and cfg["deployment"]["chips"] == 1
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"],
            cfg["vocab_size"], cfg["kv_lora_rank"]) == (27, 64, 163840, 512)


def test_reference_loads_no_kernel_and_no_jax():
    code = ("import sys, json; sys.path[:0] = [%r]; "
            "import dcoc_bench.reference.deepseek_v3, dcoc_bench.roofline_lm;"
            " print(json.dumps(sorted(sys.modules)))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "flax",
                                                   "repro", "repro_torch"}


def test_span_attribution_by_correlation_id():
    """A kernel counts to the range its launching host call started in:
    by the host op's correlation id (``linked_correlation_id``), else the
    runtime call's (its own)."""
    import torch
    gen = harness.generator("serve_decode")
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, start, end, corr, linked=0, annotation=False):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            start_ns=lambda: start, end_ns=lambda: end,
            duration_ns=lambda: end - start, correlation_id=lambda: corr,
            linked_correlation_id=lambda: linked,
            is_user_annotation=lambda: annotation)
    events = [ev("mla", cpu, 0, 100, 1, annotation=True),
              ev("aten::mm", cpu, 10, 20, 2),
              ev("moe", cpu, 100, 200, 3, annotation=True),
              ev("cudaLaunchKernel", cpu, 150, 151, 9),
              ev("aten::add", cpu, 300, 310, 4),
              ev("mla", cuda, 1000, 1500, 5, annotation=True),
              ev("gemm", cuda, 1000, 1400, 6, linked=2),
              ev("topk", cuda, 1500, 1600, 9),
              ev("add", cuda, 1600, 1700, 7, linked=4)]
    got = gen.span_device_seconds(events)
    assert got == {"mla": 400e-9, "moe": 100e-9, "mlp": 0.0}


def test_readers_read_nothing_without_a_trace():
    run = harness.make_run(CELL, 1, 1.0, False, device="cpu")
    for name in ("mla_ms.dec", "moe_ms.dec", "decode_roofline.dec",
                 "idle_pct.dec", "dispatch_ms.dec"):
        assert harness.reader(name).read(run) is None


def test_decode_roofline_bound():
    """At 64 slots of 3,000 positions with all 64 experts touched: 31.2
    GB of weights (the routed experts 28.8) and 6.0 GB of latent cache,
    bound by bytes: 11.1 ms."""
    cfg = harness.load_json(harness.BENCH_DIR, "configs",
                            "moonlight-16b-a3b.json")
    ctx = [3000] * 64
    by = roofline_lm.decode_step_bytes(cfg, ctx, 64)
    assert 37.0e9 < by < 37.5e9
    bound = roofline_lm.decode_step_bound_s(cfg, ctx, 64)
    assert bound == by / 3.35e12 and 11.0e-3 < bound < 11.2e-3
    assert roofline_lm.decode_step_flops(cfg, ctx, 64) / 989e12 < bound / 10
    assert roofline_lm.decode_step_bytes(cfg, ctx, 32) < by - 14e9
