"""The ``kimilinear.decode-b256`` cell at a tiny size on the CPU: it comes
out correct through ``harness.run_local``, and the planted faults
(``serve_decode_kda.FAULTS``) do not; the control one precision down
fails its limits; ``update_gap`` tells an fp32 KDA step from a state
rounded to bf16; its configuration file is the program's
registered config at published widths, cut only in the experts held;
its reference loads no kernel of the program and no JAX; its readers
and the KDA and step rooflines."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from dcoc_bench import harness, roofline_kda  # noqa: E402

CELL = "kimilinear.decode-b256"
# the published block at a width the CPU runs in seconds: the first
# period and the last (KDA x3, MLA, KDA x2, MLA), 4 of 8 experts held
TINY = dict(hidden_size=64, num_hidden_layers=7, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=32,
            intermediate_size=96, num_experts=4, num_experts_per_token=2,
            vocab_size=512, dtype="float32",
            linear_attn_config={"full_attn_layers": [4, 7],
                                "kda_layers": [1, 2, 3, 5, 6],
                                "head_dim": 16, "num_heads": 4,
                                "short_conv_kernel_size": 4},
            deployment={"num_experts_published": 8, "experts_held_from": 0},
            assumed={"kda_gate_rank": 8, "correction_bias_std": 0.05})
MIX = dict(slots=4, max_len=512, prompt_min=8, prompt_max=90, warmup_steps=2,
           traced_steps=2, checked_slots=2, checked_steps=2, check_span=6)
SEED = 2 ** 31 + 12345


def _run(fault=None):
    import contextlib
    gen = harness.generator("serve_decode_kda")
    with gen.planted(fault) if fault else contextlib.nullcontext():
        return harness.run_local(CELL, SEED, 0.2, mix_overrides=MIX,
                                 config_overrides=TINY)


def test_tiny_cell_is_correct():
    run, res = _run()
    assert res["correct"] is True
    assert res["checks"]["drop_gap"]["value"] == 0
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["checks"]["route_gap"]["value"] == 0
    assert res["checks"]["update_gap"]["value"] < 1e-6
    assert res["metrics"]["fwd_p95_ms"]["value"] > 0
    assert res["detail"]["finished"] == 0
    assert res["attempted"] == res["detail"]["steps"] * MIX["slots"]
    from repro_torch.models import moe as MOE
    assert len(run.state["captured"]) == MIX["checked_slots"] * 2
    assert MOE.route_log is None
    assert run.state["dropped"] == 0


def test_planted_faults_are_not_correct():
    """Every fault the limits were set against; the state kept in bf16
    by ``update_gap`` alone."""
    gen = harness.generator("serve_decode_kda")
    for fault in gen.FAULTS:
        assert _run(fault)[1]["correct"] is False, fault
    checks = _run("state_bf16")[1]["checks"]
    assert checks["update_gap"]["value"] > 10 * checks["update_gap"]["limit"]


@pytest.mark.parametrize("d", [16, 128])
def test_update_gap_tells_an_fp32_step_from_a_bf16_state(d):
    """A KDA step of fp32 states reads under 1e-6, the same step with the
    states rounded to bf16 over 1e-4 (rows the rounding leaves as they
    were among them, and a zero row); a step whose state change is no
    delta-rule step (a second rank-one term) reads far above both."""
    import torch
    from repro_torch.kernels import kda_decode as KK
    gen = harness.generator("serve_decode_kda")
    g = torch.Generator().manual_seed(d)
    rnd = lambda *s: torch.randn(s, generator=g)
    b, h = 2, 3
    state = rnd(b, h, d, d)
    q, k, v = rnd(b, h, d), rnd(b, h, d), rnd(b, h, d)
    decay = -2 * torch.rand((b, h, d), generator=g)
    beta = torch.rand((b, h), generator=g)
    k[..., :5], decay[..., :5] = 1e-6, 0.0     # rows a bf16 state keeps
    state[0, 0, 5] = 0.0
    before = state.clone()
    KK.kda_recurrence(q, k, v, decay, beta, state, d ** -0.5)
    assert gen.update_gap(before, state) < 1e-6
    low = before.bfloat16().float()
    after = low.clone()
    KK.kda_recurrence(q, k, v, decay, beta, after, d ** -0.5)
    after = after.bfloat16().float()
    assert (after == low).all(-1).any()
    assert gen.update_gap(low, after) > 1e-4
    second = rnd(b, h, d)[..., :, None] * rnd(b, h, d)[..., None, :]
    other = state + 0.1 * second
    assert gen.update_gap(before, other) > 1e-2


@pytest.mark.parametrize("quant,caught", [("bf16", False), ("fp8", True)])
def test_control_one_precision_down(quant, caught):
    """The reference in the program's place: rounded to bf16 (the
    configuration's precision) it stays inside the limits; to fp8 (one
    below) it fails them."""
    gen = harness.generator("serve_decode_kda")
    run = harness.make_run(CELL, SEED, 0.2, False, device="cpu",
                           mix_overrides=MIX, config_overrides=TINY)
    harness.execute(run, 0.0)
    checks = gen.control_checks(run, run.state["params"], quant)
    limits = run.workload["limits"]
    assert any(checks[k] > limits[k] for k in checks) is caught
    # its KDA state kept in bf16 at fp8, in fp32 at bf16
    assert (checks["update_gap"] > limits["update_gap"]) is caught


def test_config_file_is_the_registered_config():
    from repro_torch.configs import get_config
    gen = harness.generator("serve_decode_kda")
    cfg = harness.load_json(harness.BENCH_DIR, "configs",
                            "kimi-linear-48b-a3b.json")
    assert gen.arch_config(cfg) == get_config("kimi-linear-48b-a3b")
    for bad in (dict(cfg, mla_use_nope=False),
                dict(cfg, linear_attn_config=dict(
                    cfg["linear_attn_config"], kda_layers=[1, 2]))):
        with pytest.raises(ValueError):
            gen.arch_config(bad)


def test_config_file_holds_the_catalog_numbers():
    """Every key of the catalog's config as published but the experts
    held here; the published 256 and the 8-chip deployment stated."""
    cfg = harness.load_json(harness.BENCH_DIR, "configs",
                            "kimi-linear-48b-a3b.json")
    assert cfg["reduced"] == ["num_experts"] and cfg["num_experts"] == 32
    dep = cfg["deployment"]
    assert (dep["chips"], dep["expert_parallel"],
            dep["num_experts_published"]) == (8, 8, 256)
    assert dep["num_experts_held"] == 32 and dep["experts_held_from"] == 0
    la = cfg["linear_attn_config"]
    assert la["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27]
    assert sorted(la["kda_layers"] + la["full_attn_layers"]) == list(
        range(1, 28))
    assert (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"],
            cfg["num_experts_per_token"], cfg["moe_intermediate_size"],
            cfg["intermediate_size"]) == (27, 2304, 163840, 8, 1024, 9216)


def test_reference_loads_no_kernel_and_no_jax():
    code = ("import sys, json; sys.path[:0] = [%r]; "
            "import dcoc_bench.reference.kimi_linear, "
            "dcoc_bench.roofline_kda; print(json.dumps(sorted(sys.modules)))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "flax",
                                                   "repro", "repro_torch"}


def test_readers_read_nothing_without_a_trace():
    run = harness.make_run(CELL, 1, 1.0, False, device="cpu")
    for name in ("kda_ms.kl", "kda_roofline.kl", "step_mfu.kl", "mla_ms.kl",
                 "moe_ms.kl", "idle_pct.kl", "dispatch_ms.kl"):
        assert harness.reader(name).read(run) is None


def test_kda_kernel_and_step_rooflines():
    """The KDA decode kernel at the cell's 256 slots: 32 heads of 128 x
    128 fp32 states read and written, with q, k, v, g, beta and the
    output 1.095 GB, bound by bytes: 0.3268 ms.  A step at 2,500
    positions a slot with 24 held experts touched a layer: 20 layers'
    calls (21.9 GB), the weights and the latent cache; 40.0 GB, bound by
    bytes: 11.95 ms."""
    cfg = harness.load_json(harness.BENCH_DIR, "configs",
                            "kimi-linear-48b-a3b.json")
    assert roofline_kda.kda_layers(cfg) == 20
    by = roofline_kda.kda_kernel_bytes(cfg, 256)
    assert 1.09e9 < by < 1.10e9
    bound = roofline_kda.kda_kernel_bound_s(cfg, 256)
    assert bound == by / 3.35e12
    ctx = [2500] * 256
    step = roofline_kda.step_bytes(cfg, ctx, 24)
    assert 20 * by < step and 40.0e9 < step < 41.0e9
    t = roofline_kda.step_bound_s(cfg, ctx, 24, 256)
    assert t == step / 3.35e12
    assert roofline_kda.step_flops(cfg, ctx, 256) / 989e12 < t / 5
    assert roofline_kda.step_bytes(cfg, ctx, 32) > step
