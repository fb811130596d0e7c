#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on ``cuda:0``: the paper's own loop at full
ResNet-18 width, its baselines and its network co-optimization with the
co-optimized chip's mappings deployed, and the LM server at qwen2-1.5b's
full width and depth.

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the three Hopper kernels (GEMM, RMSNorm, flash attention) from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` each, all at once, and
   prints what ``ptxas -v`` says of the fp32 GEMM's, the bf16 flash
   kernel's and the RMSNorm kernel's templates (registers, spills, static
   shared memory), and which RMSNorm templates the LM path runs;
3. holds each kernel against its plain PyTorch version on the card, fp32
   and bf16: the reference test shapes and configs, the GEMM's split-K
   shapes and misaligned row strides, the 8 ResNet-18 im2col shapes at
   batch 8 under the default and knob-derived configs, the GEMM's
   ``out_dtype`` both ways (fp32 -> bf16, bf16 -> fp32), flash at every
   head_dim template with GQA, window 32 and ragged S, and the LM's shapes
   (RMSNorm over prompts of 200, 384 and 1024 rows and (8, 1536), plus
   4096 rows, (9000, 128), (5000, 4096), the widest row and x at an offset
   of one value, which takes the scalar template; it fails unless the
   checks ran every RMSNorm layout the LM path runs and the grid-stride
   loop; causal flash over B=1, S in
   {256, 1000, 2048}, 12 query and 2 KV heads, head_dim 128); there the
   bf16 flash kernel is also held against the plain version with P kept
   in fp32 (the reference kernel's arithmetic), within 2^-7 x max |v|;
4. tunes the 8 ResNet-18 conv tasks (batch 8) with the port's ``Session``;
5. deploys: runs ResNet-18 at 224x224, batch 8, fp32, seeded weights, each
   conv layer through the GEMM with its tuned geometry, and compares the
   logits with the plain path (cuDNN fp32 convolutions, TF32 off); the
   GEMM's launch counter must rise by exactly 17 in that forward; then
   times the forward and profiles it (host wall vs device busy time);
6. times each ResNet-18 GEMM shape (kernel and one ``torch.matmul`` call
   as a yardstick, each through Python calls and as device time in a CUDA
   graph; the plain version; the card's bound) and the forward;
7. ``[baselines]``: random search, AutoTVM and CHAMELEON tune the same 8
   tasks at ARCO's budget and seed; tuning seconds and network latency
   (the analytical TPU v5e model) beside ARCO's; every task ends with the
   budget's measurements and the default hardware geometry;
8. ``[netopt]``: the network co-optimizer at K=1 (``NetOptConfig()``), the
   hw-frozen baseline at its upper budget, the co-optimizer at K=2;
   seconds, network latency (model), measurements, candidates; gated on
   the shared-hardware invariant, the K=2 partition and the budget;
9. ``[netopt deploy]``: the GEMM count set to 0, ResNet-18 run with each
   layer's mapping under the K=1 chip (17 launches, logits within 1e-4 of
   cuDNN fp32), timed beside phase 5's forward and cuDNN's, profiled, and
   each GEMM shape's device time under these geometries beside phase 6's;
10. qwen2-1.5b with seeded random weights: the kernel path against the
   plain path (prefill + teacher-forced decode, 2 prompts) in fp32, gated
   at 1e-4 of max |logit|, then with the weights cast to bf16, gated at
   5e-2;
11. serves 16 requests (prompts of 128-1024 tokens, 32 new tokens each)
   through ``Server(n_slots=8, max_len=2048)`` in bf16, with the RMSNorm
   and flash launch counts set to 0 just before and checked at every
   step (a prefill: flash 28, RMSNorm 57; a decode step: RMSNorm 57,
   flash 0), and reports tokens/s, prefill ms by prompt length and the
   decode step with 8 active slots;
12. profiles one prefill and a few decode steps (``torch.profiler``):
   host wall vs device busy time, kernels launched, the top kernels;
13. times the two LM kernels at the serving run's shapes (kernel and one
   PyTorch call as device time in a CUDA graph, plain version, bound),
   the RMSNorm kernel's floor (a (1, 32) launch) and its wrapper's host
   microseconds a call, and prints one JSON line with the three kernels.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises, so the script exits non-zero and prints no result; without a GPU,
or without the repository's ``src/repro_torch`` beside it, it exits 2.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 8
TUNE_BUDGET = 48          # measurements per task (TunerConfig.fast schedule)
# H100 SXM datasheet peaks (the bound of each GEMM)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # fp32 outside the tensor cores: the kernel has no TF32
FP32_TOL = 5e-5           # max |kernel - plain| / max |plain|: two fp32 sums
BF16_TOL = 1e-2           # ... both rounded once to bf16 (2^-8 relative step)
# bf16 flash vs the plain version with P in fp32: P rounded to bf16 (2^-8
# of each weight, so at most 2^-8 max|v| in a row) and the output rounded
# to bf16 (2^-8 |o| <= 2^-8 max|v|); fp32 reassociation is far below it
FLASH_FP32_P_BOUND = 2 ** -7  # x max |v|
FORWARD_TOL = 1e-4        # max |logit diff| / max |logit|, as the CPU tests
BASELINES = ("random", "autotvm", "chameleon")
NETWORK = "resnet-18"     # the netopt runs' network label
BF16_FLOPS = 989e12       # dense bf16 tensor-core peak (the flash bound)
KERNELS = ("gemm", "rmsnorm", "flash_attention")
REFERENCE_SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
                    (257, 129, 65)]
REFERENCE_CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
                     (16, 64, 128, False, True), (8, 128, 256, True, False)]
# ((M, K, N), config): split-K (conv8b, conv6b at their tuned tiles) and
# misaligned row strides (conv1's K 147; K 129 with N 33; K 1029, split)
GEMM_EXTRA_CHECKS = [((392, 4608, 512), (32, 256, 2304, True, True)),
                     ((1568, 2304, 256), (128, 128, 2304, True, True)),
                     ((392, 4608, 512), (128, 128, 128, True, True)),
                     ((1568, 147, 64), (128, 64, 128, True, True)),
                     ((257, 129, 33), (64, 32, 32, True, True)),
                     ((257, 1029, 33), (64, 32, 32, True, True))]
# LM serving path: qwen2-1.5b at its published width and depth, bf16
LM_ARCH = "qwen2-1.5b"
LM_SLOTS, LM_MAX_LEN = 8, 2048
LM_REQUESTS, LM_NEW = 16, 32
LM_PROMPT = (128, 1024)   # prompt lengths drawn uniformly in this range
PREFILL_BINS = (128, 256, 512)
LM_GATE_REQUESTS, LM_GATE_STEPS = 2, 4
LM_TOL_FP32 = 1e-4        # max |logit diff| / max |logit|, kernel vs plain
LM_TOL_BF16 = 5e-2        # the same in bf16: both paths round every layer's
                          # output to bf16 (2^-8), 28 layers compound it
FLASH_TIMED_S = (256, 1024, 2048)
NORM_TIMED_ROWS = 1024
NORM_FLOOR_SHAPE = (1, 32)  # the least work of a launch: its floor
NORM_HOST_CALLS = 1000      # wrapper calls timed by the host clock
# (shape, on the serving path, 16-byte aligned): the reference's test
# shapes, the path's (a decode step's 8 rows and a prompt of 200, which
# spread a row over warps; prompts of 384 and 1024, one warp a row in
# bf16), 4096 rows, the grid-stride loop of one-warp rows (9000, 128) and
# of wider ones (5000, 4096), the widest row, and x at an offset of one
# value (the scalar template)
RMSNORM_CHECKS = [((4, 64), False, True), ((2, 100, 96), False, True),
                  ((1, 7, 33), False, True), ((129, 256), False, True),
                  ((200, 1536), True, True), ((384, 1536), True, True),
                  ((1024, 1536), True, True), ((8, 1536), True, True),
                  ((4096, 1536), False, True), ((9000, 128), False, True),
                  ((5000, 4096), False, True), ((3, 8192), False, True),
                  ((5, 1536), False, False), ((3, 8192), False, False)]
# ((B, S, HQ, HKV, D, causal, window, block_q, block_k), on the path)
FLASH_CHECKS = (
    [((2, 100, hq, hkv, 16, causal, window, 32, 32), False)
     for hq, hkv in ((4, 4), (4, 2), (6, 1))
     for causal, window in ((True, None), (False, None), (True, 32))]
    + [((1, s, 2, 2, 8, causal, None, bq, bk), False)
       for s, bq, bk, causal in ((3, 16, 16, True), (37, 16, 64, False),
                                 (70, 32, 16, True))]
    + [((2, 77, 6, 2, d, True, 32, 64, 64), False) for d in (8, 16, 64, 128)]
    + [((1, 150, 12, 2, 128, False, None, 128, 128), False),
       ((2, 130, 4, 1, 64, True, None, 32, 64), False),
       ((1, 50, 2, 1, 20, True, None, 64, 64), False)]
    + [((1, s, 12, 2, 128, True, None, 128, 128), True)
       for s in (256, 1000, 2048)])
# the port's kernels as the profiler names them
PORT_KERNEL_NAMES = ("gemm_f32_kernel", "splitk_sum_kernel",
                     "gemm_loop_kernel", "flash_mma_kernel",
                     "flash_ffma_kernel", "rmsnorm_kernel")
# the templates redesigned for the card, whose ptxas lines are printed
NEW_TEMPLATES = ("gemm_f32_kernel", "splitk_sum_kernel", "flash_mma_kernel",
                 "rmsnorm_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple:
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.float().abs().max()), 1e-30)


def gemm_shapes(model: str = "resnet-18", batch: int = BATCH):
    """(task name, M, N, K, layers) of each unique conv GEMM of ``model``."""
    from repro_torch.core.task import conv_tasks
    out = []
    for t in conv_tasks(model, batch=batch):
        wl = t.space.workload
        oh = (wl["h"] + 2 * wl["pad"] - wl["kh"]) // wl["stride"] + 1
        ow = (wl["w"] + 2 * wl["pad"] - wl["kw"]) // wl["stride"] + 1
        out.append((t.name, wl["b"] * oh * ow, wl["co"],
                    wl["ci"] * wl["kh"] * wl["kw"], t.multiplicity))
    return out


def knob_config(settings, spec):
    """A task's tuned knob settings -> the GEMM geometry of one layer."""
    from repro_torch.kernels.gemm import gemm_config_from_knobs
    return gemm_config_from_knobs(
        tile_m=settings["tile_b"] * settings["tile_h"] * settings["tile_w"],
        tile_n=settings["tile_co"],
        tile_k=settings["tile_ci"] * spec.kh * spec.kw,
        h_threading=settings["h_threading"],
        oc_threading=settings["oc_threading"])


# ------------------------------------------------------------------ phases

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    log(out[0])
    return out[0]


def phase_build() -> float:
    """Builds the three kernels, one nvcc each, all started together, and
    prints ptxas's registers, spills and static shared memory of each new
    template (the dynamic shared memory a launch asks for is printed with
    its run geometry by the checks)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_kernel = _build.build_all(KERNELS)
    dt = time.perf_counter() - t0
    for name, secs in per_kernel.items():
        log(f"[build] {os.path.relpath(_build.build(name), ROOT)} "
            f"in {secs:.1f} s")
    log(f"[build] {len(per_kernel)} kernels in {dt:.1f} s (in parallel)")
    spills, seen = 0, set()
    for name in KERNELS:
        for r in _build.ptxas_report(name):
            base = r["kernel"].partition("<")[0]
            if base not in NEW_TEMPLATES:
                continue
            seen.add(base)
            spills += r["spill_stores"] + r["spill_loads"]
            log(f"[build] ptxas {r['kernel']}: {r['registers']} registers, "
                f"spill stores {r['spill_stores']} B, loads "
                f"{r['spill_loads']} B, static smem {r['static_smem']} B")
    check(seen == set(NEW_TEMPLATES),
          f"ptxas reported {sorted(seen)}, not every one of {NEW_TEMPLATES}")
    log(f"[build] new templates spill {spills} bytes in all")
    log_lm_rmsnorm_templates()
    return dt


def lm_rmsnorm_layouts() -> dict:
    """The RMSNorm layouts the LM path runs at d_model (bf16 serving, the
    fp32 gate) for 1 to LM_PROMPT[1] rows: (d, dtype, 16-byte copies,
    warps a row, slots a lane, rows a block) -> the rows that run it."""
    import torch
    from repro_torch.kernels import rmsnorm as RN
    d = lm_config(torch.bfloat16).d_model
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rows in range(1, LM_PROMPT[1] + 1):
            g = RN.legalize(d, rows, dtype)
            out.setdefault((d, dtype, g.vec, g.warps_per_row, g.slots,
                            g.rows_per_block), []).append(rows)
    return out


def log_lm_rmsnorm_templates() -> None:
    """The RMSNorm templates the LM path runs, with ptxas's registers and
    spills."""
    import torch
    from repro_torch.kernels import _build
    reports = {r["kernel"]: r for r in _build.ptxas_report("rmsnorm")}
    ctypes = {torch.bfloat16: "__nv_bfloat16", torch.float32: "float"}
    spills = 0
    for (d, dtype, vec, warps, slots, rpb), rows in \
            lm_rmsnorm_layouts().items():
        name = (f"rmsnorm_kernel<{ctypes[dtype]}, {ctypes[dtype]}, "
                f"{int(vec)}, {slots}>")
        check(name in reports, f"ptxas reported no {name}")
        r = reports[name]
        spills += r["spill_stores"] + r["spill_loads"]
        log(f"[build] the LM path's RMSNorm at d {d}, rows {rows[0]}-"
            f"{rows[-1]}: {name}, {warps} warps a row, {rpb} a block: "
            f"{r['registers']} registers, spills "
            f"{r['spill_stores'] + r['spill_loads']} B")
    log(f"[build] the LM path's RMSNorm templates spill {spills} bytes")


def phase_check_kernel(dev) -> float:
    """Kernel vs plain version on the reference test cases and the main
    path's shapes; returns the largest absolute fp32 error at the main
    path's shapes."""
    import torch
    from repro_torch.core.task import conv_tasks
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_checks = 0
    for m, k, n in REFERENCE_SHAPES:
        for cfg in REFERENCE_CONFIGS:
            for dtype, tol in ((torch.float32, FP32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                b = torch.randn(k, n, generator=gen, device=dev).to(dtype)
                c = G.GemmConfig(*cfg)
                got = G.gemm(a, b, c)
                want = G.gemm(a, b, c, use_kernel=False)
                torch.cuda.synchronize()
                _, rel = rel_err(got, want)
                check(got.dtype == dtype and rel <= tol,
                      f"gemm {(m, k, n)} {cfg} {dtype}: rel err {rel:.3g}")
                n_checks += 1
    # out_dtype both ways; fp32 -> bf16 also through split-K
    pairs = ((torch.float32, torch.bfloat16, BF16_TOL),
             (torch.bfloat16, torch.float32, FP32_TOL))
    cases = [(shape, cfg, pair) for shape in REFERENCE_SHAPES
             for cfg in REFERENCE_CONFIGS for pair in pairs]
    cases += [(shape, cfg, pairs[0]) for shape, cfg in GEMM_EXTRA_CHECKS[:3]]
    for (m, k, n), cfg, (src, dst, tol) in cases:
        a = torch.randn(m, k, generator=gen, device=dev).to(src)
        b = torch.randn(k, n, generator=gen, device=dev).to(src)
        c = G.GemmConfig(*cfg)
        got = G.gemm(a, b, c, out_dtype=dst)
        run = G.gemm.last_geometry["run"]
        want = G.gemm(a, b, c, out_dtype=dst, use_kernel=False)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, want)
        check(got.dtype == dst and rel <= tol,
              f"gemm {(m, k, n)} {cfg} {src} -> {dst}: rel err {rel:.3g}")
        if run["split_k"] > 1:
            log(f"[check] gemm M={m} K={k} N={n} fp32 -> bf16 run={run} "
                f"max_abs_err={diff:.3g} rel={rel:.3g}")
        n_checks += 1
    log(f"[check] gemm out_dtype fp32 -> bf16 (tol {BF16_TOL}) and bf16 -> "
        f"fp32 (tol {FP32_TOL}): {len(cases)} checks passed")
    for (m, k, n), cfg in GEMM_EXTRA_CHECKS:
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        c = G.GemmConfig(*cfg)
        got = G.gemm(a, b, c)
        run = G.gemm.last_geometry["run"]
        want = G.gemm(a, b, c, use_kernel=False)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, want)
        check(rel <= FP32_TOL, f"gemm {(m, k, n)} {run}: rel err {rel:.3g}")
        log(f"[check] gemm M={m} K={k} N={n} run={run} dynamic smem "
            f"{G.RunGeometry(**run).smem_bytes} B max_abs_err={diff:.3g} "
            f"rel={rel:.3g}")
        n_checks += 1
    worst = 0.0
    tasks = conv_tasks("resnet-18", batch=BATCH)
    for (name, m, n, k, _), task in zip(gemm_shapes(), tasks):
        # knob-derived geometries: every M template (16, 32, 64 from small
        # spatial tiles, 128 from the default), the task's extreme Ci/Co
        sp, wl = task.space, task.space.workload
        kk = wl["kh"] * wl["kw"]
        configs = [G.GemmConfig()] + [
            G.gemm_config_from_knobs(tm, sp.choices[2][i],
                                     sp.choices[1][i] * kk, 2, 2)
            for tm, i in ((1, 0), (32, -1), (64, 0))]
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        for cfg in configs:
            got = G.gemm(a, b, cfg)
            run = G.gemm.last_geometry["run"]
            want = G.gemm(a, b, cfg, use_kernel=False)
            torch.cuda.synchronize()
            diff, rel = rel_err(got, want)
            check(rel <= FP32_TOL,
                  f"gemm {name} {(m, n, k)} {run}: rel err {rel:.3g}")
            worst = max(worst, diff)
            n_checks += 1
            log(f"[check] {name} M={m} N={n} K={k} run={run} dynamic "
                f"smem {G.RunGeometry(**run).smem_bytes} B "
                f"max_abs_err={diff:.3g} rel={rel:.3g}")
    log(f"[check] {n_checks} kernel-vs-plain checks passed "
        f"(fp32 tol {FP32_TOL} x max|plain|, bf16 {BF16_TOL})")
    return worst


def phase_tune(dev):
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.tuner import TunerConfig
    import torch
    tasks = TuningTask.conv_tasks("resnet-18", batch=BATCH)
    check(len(tasks) == 8 and sum(t.multiplicity for t in tasks) == 17,
          "ResNet-18 must give 8 tasks over 17 layers")
    t0 = time.perf_counter()
    rep = Session(tasks, tuner=TunerConfig.fast(), budget=TUNE_BUDGET,
                  seed=SEED, device=dev).run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in rep:
        check(r.n_measurements == TUNE_BUDGET and math.isfinite(r.best_latency)
              and r.best_settings is not None, f"tuning {r.task} failed")
        log(f"[tune] {r.task} x{r.multiplicity} best {r.best_latency:.4g} s "
            f"(analytical TPU v5e model) {r.best_settings}")
    log(f"[tune] 8 tasks x {TUNE_BUDGET} measurements in {dt:.2f} s")
    return rep, dt


def phase_episode_time(dev) -> float:
    """Device time of one MAPPO episode (TunerConfig.fast) on the card."""
    import torch
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core import mappo
    from repro_torch.core.agents import init_marl_params
    from repro_torch.core.cost_model import GBTModel
    from repro_torch.core.tuner import TunerConfig
    hp = TunerConfig.fast().mappo
    space = TuningTask.conv_tasks("resnet-18", batch=BATCH)[1].space
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfgs = space.random_configs(gen, 64)
    gbt = GBTModel(n_rounds=16)
    gbt.update(space.feature_vector(cfgs).cpu().numpy(),
               -torch.log(space.measure(cfgs)).cpu().numpy())
    env = mappo.env_params_from_space(space, device=dev)
    forest = gbt.to_forest(dev)
    nets = init_marl_params(SEED, device=dev)
    opt = mappo.make_optimizer(nets, hp)
    ms = cuda_ms(lambda: mappo.train_episode(nets, opt, gen, env, forest, hp),
                 reps=5)
    log(f"[tune] one MAPPO episode (n_steps={hp.n_steps}, n_envs="
        f"{hp.n_envs}, {hp.epochs} epochs) {ms:.2f} ms")
    return ms


def resnet_setup(dev):
    """ResNet-18's conv specs, each layer's task name, the seeded weights
    and the 224x224 batch-8 input that every deploy phase runs."""
    import torch
    from repro_torch.core.task import conv_tasks
    from repro_torch.models import cnn
    specs = cnn.conv_specs("resnet-18")
    layer_task = {}
    for t in conv_tasks("resnet-18", batch=BATCH):
        for layer in t.layer_names:
            layer_task[layer] = t.name
    net = cnn.init_params(SEED, "resnet-18", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
    return specs, layer_task, net, x


def phase_deploy(dev, rep):
    """Full-width ResNet-18 forward with tuned per-layer geometries; reads
    the kernel's launch count right after the first forward (the count was
    set to 0 before tuning, where the main path starts)."""
    import torch
    from repro_torch.kernels import gemm as G
    specs, layer_task, net, x = resnet_setup(dev)
    configs = [knob_config(rep[layer_task[s.name]].best_settings, s)
               for s in specs]
    with torch.no_grad():
        logits = net(x, configs)
        torch.cuda.synchronize()
        launches = G.gemm.launches   # the main path ends here
        check(launches == 17, f"forward launched the kernel {launches} "
                              "times, expected 17")
        plain = net(x, use_kernel=False)
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, 1000), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    diff, rel = rel_err(logits, plain)
    check(rel <= FORWARD_TOL, f"forward vs plain path: rel err {rel:.3g}")
    log(f"[deploy] ResNet-18 224x224 batch {BATCH}: 17 kernel launches, "
        f"logits max_abs_err {diff:.3g} (rel {rel:.3g}) vs cuDNN fp32")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(x, configs), reps=5)
        plain_fwd_ms = cuda_ms(lambda: net(x, use_kernel=False), reps=5)
    log(f"[deploy] forward {fwd_ms:.3f} ms through the kernel, "
        f"{plain_fwd_ms:.3f} ms through cuDNN fp32 convolutions")
    with torch.no_grad():   # where the forward's time goes
        profile_runs({"forward": (3, lambda: net(x, configs))})
    per_shape = {}
    for s, cfg in zip(specs, configs):
        per_shape.setdefault(layer_task[s.name], cfg)
    return launches, diff, fwd_ms, plain_fwd_ms, per_shape


def phase_time_shapes(dev, per_shape):
    """Per-shape kernel / plain / library times and bounds at batch 8.
    ``ms`` and ``library_ms`` are CUDA-event times over Python calls
    (``cuda_ms``), the method of the first port's numbers; ``device_ms``
    and ``library_device_ms`` are the same calls captured in a CUDA graph
    (``device_ms``), without the host's launch overhead."""
    import torch
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    for name, m, n, k, layers in gemm_shapes():
        cfg = per_shape[name]
        geom = G.legalize(cfg, m, n, k)
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        ms = cuda_ms(lambda: G.gemm(a, b, cfg), reps=20)
        dev_ms = device_ms(lambda: G.gemm(a, b, cfg))
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), reps=20)
        lib_dev_ms = device_ms(lambda: torch.matmul(a, b))
        plain_ms = cuda_ms(lambda: G.gemm_plain(a, b, geom), reps=1)
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n)
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row = {"task": name, "M": m, "N": n, "K": k, "layers": layers,
               "run": [geom.bm, geom.bn, geom.bk], "split_k": geom.split_k,
               "vec": geom.vec,
               "requested": [cfg.block_m, cfg.block_n, cfg.block_k],
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / ms / 1e9,
               "device_tflops": flops / dev_ms / 1e9}
        rows.append(row)
        log(f"[time] {name} M={m} N={n} K={k} x{layers} run={row['run']} "
            f"split_k={geom.split_k} vec={geom.vec} "
            f"kernel {ms:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
            f"{100 * row['bound_ms'] / ms:.1f}% of bound), "
            f"device time {dev_ms:.4f} ms "
            f"({100 * row['bound_ms'] / dev_ms:.1f}% of bound), "
            f"torch.matmul {lib_ms:.4f} ms (device time {lib_dev_ms:.4f}), "
            f"plain {plain_ms:.1f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


# ------------------------------------------------ baselines and netopt

def timed(fn):
    """(fn's result, host seconds ending in a synchronize)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_baselines(dev, arco_rep, arco_s) -> dict:
    """The paper's comparison: each baseline tunes the 8 ResNet-18 tasks
    at ARCO's budget and seed on the card.  Gated on structure only (one
    seed decides which algorithm wins): every task ends with the budget's
    measurements, a finite best and the default hardware geometry (the
    baselines explore software knobs only)."""
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.baselines import default_hardware_values
    from repro_torch.core.tuner import TunerConfig
    tasks = TuningTask.conv_tasks("resnet-18", batch=BATCH)
    out = {"arco": {"tune_s": arco_s,
                    "network_latency_s": arco_rep.network_latency()}}
    for algo in BASELINES:
        rep, dt = timed(lambda: Session(
            tasks, tuner=TunerConfig.fast(), algo=algo, budget=TUNE_BUDGET,
            seed=SEED, device=dev).run())
        for t in tasks:
            r = rep[t.name]
            check(r.n_measurements == TUNE_BUDGET
                  and math.isfinite(r.best_latency),
                  f"{algo} {t.name}: {r.n_measurements} measurements, best "
                  f"{r.best_latency}")
            hw = [int(t.space.choices[k][i])
                  for k, i in enumerate(r.best_config[:3])]
            check(hw == [int(v) for v in default_hardware_values(t.space)],
                  f"{algo} {t.name} moved the hardware knobs: {hw}")
        out[algo] = {"tune_s": dt,
                     "network_latency_s": rep.network_latency()}
        log(f"[baselines] {algo}: 8 tasks x {TUNE_BUDGET} measurements in "
            f"{dt:.2f} s, network latency {rep.network_latency():.4g} s "
            f"(analytical TPU v5e model, not the H100); every task kept the "
            f"default hardware geometry")
    log("[baselines] tuning s (host clock, ended by a synchronize): "
        + ", ".join(f"{a} {v['tune_s']:.2f}" for a, v in out.items())
        + "; network latency s (analytical TPU v5e model): "
        + ", ".join(f"{a} {v['network_latency_s']:.4g}"
                    for a, v in out.items()))
    return out


def phase_netopt(dev):
    """Network co-optimization of the 8 tasks on the card: the
    co-optimizer at K=1 (``NetOptConfig()``), the hw-frozen baseline at
    the co-optimizer's upper budget, and the co-optimizer at K=2.  Gated on
    structure: every layer's mapping runs on its stage's chip, K=2 has two
    chips and one cut, no run pays more than the upper budget.  Co-opt
    against hw-frozen is printed, not gated: CUDA's reductions can move a
    seeded trajectory (the CPU tests hold that bar)."""
    import dataclasses
    from repro_torch.compiler.netopt import (NetOptConfig, NetworkCoOptimizer,
                                             network_hw_frozen_tune)
    from repro_torch.compiler.task import TuningTask
    tasks = TuningTask.conv_tasks("resnet-18", batch=BATCH)
    cfg = NetOptConfig()
    cap = cfg.total_layer_budget() * len(tasks)
    runs = {}
    runs["k1"] = timed(lambda: NetworkCoOptimizer(
        tasks, cfg, name=NETWORK, device=dev).run())
    runs["hw_frozen"] = timed(lambda: network_hw_frozen_tune(
        tasks, cfg, name=NETWORK, device=dev))
    runs["k2"] = timed(lambda: NetworkCoOptimizer(
        tasks, dataclasses.replace(cfg, k_chips=2), name=NETWORK,
        device=dev).run())
    out = {}
    for label, (rep, dt) in runs.items():
        check(rep.verify_shared_hardware(),
              f"netopt {label}: a layer runs off its stage's chip")
        check(rep.total_measurements <= cap,
              f"netopt {label}: {rep.total_measurements} measurements > "
              f"{cap}")
        check(math.isfinite(rep.network_latency) and rep.n_layers == 17,
              f"netopt {label}: latency {rep.network_latency}, "
              f"{rep.n_layers} layers")
        out[label] = {"s": dt, "network_latency_s": rep.network_latency,
                      "measurements": rep.total_measurements,
                      "candidates": rep.hw_candidates,
                      "hw_configs": rep.hw_configs,
                      "cuts": rep.partition.get("cuts", [])}
        log(f"[netopt] {label} ({rep.algo}): {dt:.2f} s, network latency "
            f"{rep.network_latency:.4g} s (analytical TPU v5e model), "
            f"{rep.total_measurements} measurements paid (cap {cap}), "
            f"{rep.hw_candidates} candidates, chips {rep.hw_configs}")
    k2 = runs["k2"][0]
    check(len(k2.hw_configs) == 2 and len(k2.partition["cuts"]) == 1,
          f"netopt K=2: {k2.hw_configs}, cuts {k2.partition['cuts']}")
    log(f"[netopt] K=2 cut before task {k2.partition['cuts'][0]} of "
        f"{len(tasks)}: stage chips {k2.hw_configs}")
    ratio = (runs["k1"][0].network_latency
             / runs["hw_frozen"][0].network_latency)
    out["k1_over_hw_frozen"] = ratio
    log(f"[netopt] co-opt K=1 / hw-frozen network latency {ratio:.4f} "
        f"(model; not gated here)")
    return runs["k1"][0], out


def phase_netopt_deploy(dev, coopt, fwd_ms, plain_fwd_ms, rows) -> dict:
    """The co-optimized network deployed: every layer's mapping under the
    K=1 winner's chip (``mapping`` with ``hw_utilized``, the chip's tiles
    clamped to the layer) mapped through ``knob_config`` to a GemmConfig,
    ResNet-18 run with phase 5's seeded weights and input.  The GEMM's
    launch count is set to 0 just before and must read 17 just after;
    logits within FORWARD_TOL of cuDNN fp32.  Then where the forward's
    time goes: the profiler over it, and each GEMM shape's device time
    under these geometries beside phase 6's (``rows``, the per-layer
    optima's)."""
    import torch
    from repro_torch.kernels import gemm as G
    specs, layer_task, net, x = resnet_setup(dev)
    G.gemm.launches = 0   # the netopt deploy path starts here
    settings = {name: {**layer["mapping"], **layer["hw_utilized"]}
                for name, layer in coopt.layers.items()}
    configs = [knob_config(settings[layer_task[s.name]], s) for s in specs]
    with torch.no_grad():
        logits = net(x, configs)
        torch.cuda.synchronize()
        launches = G.gemm.launches   # and ends here
        check(launches == 17, f"netopt deploy launched the kernel "
                              f"{launches} times, expected 17")
        plain = net(x, use_kernel=False)
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, 1000)
          and bool(torch.isfinite(logits).all()), "netopt deploy logits")
    diff, rel = rel_err(logits, plain)
    check(rel <= FORWARD_TOL, f"netopt deploy vs cuDNN: rel err {rel:.3g}")
    requested = {}
    for s, cfg in zip(specs, configs):
        requested.setdefault(layer_task[s.name], cfg)
    for name, cfg in requested.items():
        log(f"[netopt deploy] {name}: {settings[name]} -> requested "
            f"{[cfg.block_m, cfg.block_n, cfg.block_k]}")
    with torch.no_grad():
        ms = cuda_ms(lambda: net(x, configs), reps=5)
    log(f"[netopt deploy] ResNet-18 224x224 batch {BATCH}: 17 kernel "
        f"launches, logits max_abs_err {diff:.3g} (rel {rel:.3g}) vs cuDNN "
        f"fp32; forward {ms:.3f} ms with the co-optimized chip's mappings, "
        f"{fwd_ms:.3f} ms with the per-layer optima (phase 5), "
        f"{plain_fwd_ms:.3f} ms through cuDNN (phase 5)")
    with torch.no_grad():
        profile = profile_runs({"netopt forward": (3, lambda: net(x,
                                                                   configs))})
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    gemm_ms = {"netopt": 0.0, "per_layer": 0.0}
    for (name, m, n, k, layers), row in zip(gemm_shapes(), rows):
        cfg = requested[name]
        geom = G.legalize(cfg, m, n, k)
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        dev_ms = device_ms(lambda: G.gemm(a, b, cfg))
        gemm_ms["netopt"] += dev_ms * layers
        gemm_ms["per_layer"] += row["device_ms"] * layers
        log(f"[netopt deploy] {name} M={m} N={n} K={k} x{layers}: run="
            f"{[geom.bm, geom.bn, geom.bk]} split_k={geom.split_k} device "
            f"time {dev_ms:.4f} ms; the per-layer optimum's run={row['run']} "
            f"split_k={row['split_k']} {row['device_ms']:.4f} ms (phase 6)")
    log(f"[netopt deploy] the 17 GEMMs' device time (device_ms): "
        f"{gemm_ms['netopt']:.3f} ms under the co-optimized chip, "
        f"{gemm_ms['per_layer']:.3f} ms under the per-layer optima")
    return {"launches": launches, "logits_max_abs_err": diff,
            "logits_rel_err": rel, "forward_ms": ms,
            "gemm_device_ms": gemm_ms, "profile": profile}


# -------------------------------------------------------- LM serving path

def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call of ``fn`` without the host's launch
    overhead: ``reps`` calls captured in one CUDA graph, replayed, timed
    by CUDA events.  For kernels shorter than their Python launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def lm_config(dtype):
    from repro_torch.configs import get_config
    return get_config(LM_ARCH).with_(dtype=dtype, param_dtype=dtype)


def phase_check_lm_kernels(dev) -> dict:
    """RMSNorm and flash kernels vs their plain versions on the card: the
    reference's test cases and the serving path's shapes, fp32 and bf16.
    Returns each kernel's largest absolute error at the path's shapes in
    bf16, the dtype the path serves in, and under ``flash_vs_fp32_p`` the
    bf16 flash kernel's largest distance there from fp32-P attention."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {"rmsnorm": 0.0, "flash_attention": 0.0}
    n_checks = 0
    ran, strided = set(), set()   # layouts and grid-stride runs checked
    for shape, on_path, aligned in RMSNORM_CHECKS:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            n = math.prod(shape)
            x = torch.randn(n + 1, generator=gen, device=dev).to(dtype)
            x = (x[:n] if aligned else x[1:]).view(shape)
            w = torch.randn(shape[-1], generator=gen, device=dev).to(dtype)
            got = RN.rmsnorm(x, w)
            run = RN.rmsnorm.last_geometry["run"]
            want = RN.rmsnorm(x, w, use_kernel=False)
            torch.cuda.synchronize()
            diff, rel = rel_err(got, want)
            check(got.dtype == dtype and rel <= tol,
                  f"rmsnorm {shape} {dtype} {run}: rel err {rel:.3g}")
            check(run["vec"] == (aligned and shape[-1]
                                 % RN.vector_width(dtype) == 0),
                  f"rmsnorm {shape} {dtype} aligned={aligned}: run {run}")
            log(f"[check] rmsnorm {shape} {dtype}"
                f"{'' if aligned else ' x at an offset of one value'} "
                f"run={run} max_abs_err={diff:.3g} rel={rel:.3g}")
            if on_path and dtype == torch.bfloat16:
                worst["rmsnorm"] = max(worst["rmsnorm"], diff)
            ran.add((shape[-1], dtype, run["vec"], run["threads"] // 32,
                     run["slots"], run["rows_per_block"]))
            if run["grid"] * run["rows_per_block"] < n // shape[-1]:
                strided.add((run["threads"] > 32, dtype))
            n_checks += 1
    missing = set(lm_rmsnorm_layouts()) - ran
    check(not missing, f"no rmsnorm check runs the LM path's {missing}")
    check(len(strided) == 4, f"the rmsnorm grid-stride loop is checked "
          f"only in {sorted(map(str, strided))}")
    for (b, s, hq, hkv, d, causal, window, bq, bk), on_path in FLASH_CHECKS:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            q, k, v = (torch.randn(b, s, h, d, generator=gen,
                                   device=dev).to(dtype)
                       for h in (hq, hkv, hkv))
            got = FA.flash_attention(q, k, v, causal, window, None, bq, bk)
            run = FA.flash_attention.last_geometry["run"]
            want = FA.flash_attention(q, k, v, causal, window, None, bq, bk,
                                      use_kernel=False)
            torch.cuda.synchronize()
            diff, rel = rel_err(got, want)
            case = (b, s, hq, hkv, d, causal, window)
            check(got.dtype == dtype and rel <= tol,
                  f"flash {case} {dtype}: rel err {rel:.3g}")
            if on_path:
                log(f"[check] flash B={b} S={s} HQ={hq} HKV={hkv} D={d} "
                    f"{dtype} run={run} dynamic smem "
                    f"{FA.RunGeometry(**run).smem_bytes} B "
                    f"max_abs_err={diff:.3g} rel={rel:.3g}")
            if on_path and dtype == torch.bfloat16:
                worst["flash_attention"] = max(worst["flash_attention"], diff)
                exact = FA.flash_attention_plain(
                    q.float(), k.float(), v.float(), causal, window,
                    d ** -0.5, FA.RunGeometry(**run))
                diff32, rel32 = rel_err(got, exact)
                bound = FLASH_FP32_P_BOUND * float(v.float().abs().max())
                check(diff32 <= bound, f"flash {case} bf16 vs fp32 P: "
                      f"{diff32:.3g} > {bound:.3g}")
                worst["flash_vs_fp32_p"] = max(
                    worst.get("flash_vs_fp32_p", 0.0), diff32)
                log(f"[check] flash B={b} S={s} bf16 vs plain with fp32 P: "
                    f"max_abs_err={diff32:.3g} rel={rel32:.3g} (bound "
                    f"{bound:.3g} = 2^-7 x max|v|)")
            n_checks += 1
    log(f"[check] {n_checks} RMSNorm/flash kernel-vs-plain checks passed "
        f"(fp32 tol {FP32_TOL} x max|plain|, bf16 {BF16_TOL})")
    return worst


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _path_vs_plain(params, cfg, prompts, dev) -> float:
    """Largest logit difference / max |logit| between the kernel path and
    the plain path: prefill, then LM_GATE_STEPS teacher-forced decode
    steps, for each prompt (each continued by its own drawn tokens)."""
    import torch
    from repro_torch.models import transformer as T
    worst = 0.0
    for toks in prompts:
        t = torch.as_tensor(toks[None], device=dev)
        n = t.shape[1] - LM_GATE_STEPS
        caches, logits = [], []
        for use_kernel in (True, False):
            lg, cache = T.prefill(params, {"tokens": t[:, :n]}, cfg,
                                  n + LM_GATE_STEPS + 1,
                                  use_kernel=use_kernel)
            caches.append(cache)
            logits.append(lg)
        for i in range(n, n + LM_GATE_STEPS + 1):
            check(bool(torch.isfinite(logits[0]).all()), "non-finite logits")
            worst = max(worst, rel_err(logits[0], logits[1])[1])
            if i == n + LM_GATE_STEPS:
                break
            for j, use_kernel in enumerate((True, False)):
                logits[j], caches[j] = T.decode_step(
                    params, caches[j], t[:, i:i + 1], cfg,
                    use_kernel=use_kernel)
    return worst


def phase_lm_gate(dev):
    """qwen2-1.5b at full width with seeded random weights: the kernel
    path against the plain path on the card, in fp32 (gated at
    LM_TOL_FP32) and then, with the same weights cast, in bf16 (gated at
    LM_TOL_BF16).  Returns the bf16 weights for the serving phase."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    cfg32 = lm_config(torch.float32)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg32.vocab,
                            size=int(n) + LM_GATE_STEPS).astype(np.int64)
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1,
                                     size=LM_GATE_REQUESTS)]
    t0 = time.perf_counter()
    params = T.init_params(SEED, cfg32, device=dev)
    torch.cuda.synchronize()
    log(f"[lm] {LM_ARCH} full width: {cfg32.n_layers} layers, d_model "
        f"{cfg32.d_model}, {cfg32.n_heads}/{cfg32.n_kv_heads} heads, d_ff "
        f"{cfg32.d_ff}, vocab {cfg32.vocab}, {T.param_count(params)/1e9:.3f}"
        f" B params, seeded fp32 init {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        rel32 = _path_vs_plain(params, cfg32, prompts, dev)
    check(rel32 <= LM_TOL_FP32, f"fp32 kernel path vs plain path: logits "
                                f"rel err {rel32:.3g} > {LM_TOL_FP32}")
    log(f"[lm] fp32 kernel path vs plain path, prompts "
        f"{[len(p) - LM_GATE_STEPS for p in prompts]}, prefill + "
        f"{LM_GATE_STEPS} decode steps: max |logit diff| / max |logit| = "
        f"{rel32:.3g} (gate {LM_TOL_FP32})")
    params = _cast(params, torch.bfloat16)
    torch.cuda.empty_cache()
    cfg16 = lm_config(torch.bfloat16)
    with torch.no_grad():
        rel16 = _path_vs_plain(params, cfg16, prompts, dev)
    check(rel16 <= LM_TOL_BF16, f"bf16 kernel path vs plain path: logits "
                                f"rel err {rel16:.3g} > {LM_TOL_BF16}")
    log(f"[lm] bf16 kernel path vs plain path: {rel16:.3g} (gate "
        f"{LM_TOL_BF16})")
    return params, cfg16, rel32, rel16


def phase_serve(dev, params, cfg):
    """The serving path: ``Server(n_slots=8, max_len=2048)`` in bf16 serves
    16 requests (prompts drawn in LM_PROMPT, LM_NEW new tokens each).  The
    RMSNorm and flash launch counts are set to 0 just before and read just
    after, and checked step by step: each prefill launches flash once a
    layer and RMSNorm 2 n_layers + 1 times, each decode step RMSNorm
    2 n_layers + 1 times and flash never."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.train.server import DONE, Request, Server
    srv = Server(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    srv.submit(Request(uid=-1, prompt=np.arange(16, dtype=np.int32),
                       max_new_tokens=2))
    srv.run_until_drained()                     # warm-up, not counted
    rng = np.random.default_rng(SEED + 5)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, size=LM_REQUESTS)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(n))
                    .astype(np.int32), max_new_tokens=LM_NEW)
            for i, n in enumerate(lens)]
    norms = 2 * cfg.n_layers + 1
    FA.flash_attention.launches = 0   # the serving path starts here
    RN.rmsnorm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    prefills = decodes = 0
    full_step_ms = []
    while srv.active or srv.queue:
        f0, r0 = FA.flash_attention.launches, RN.rmsnorm.launches
        queued, was_active = len(srv.queue), len(srv.active)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        finished = srv.step()
        end.record()
        admitted = queued - len(srv.queue)
        decoded = int(len(srv.active) + len(finished) > 0)
        check(FA.flash_attention.launches - f0 == cfg.n_layers * admitted,
              f"flash launched {FA.flash_attention.launches - f0} times for "
              f"{admitted} prefills")
        check(RN.rmsnorm.launches - r0 == norms * (admitted + decoded),
              f"rmsnorm launched {RN.rmsnorm.launches - r0} times for "
              f"{admitted} prefills and {decoded} decode steps")
        prefills += admitted
        decodes += decoded
        if admitted == 0 and was_active == LM_SLOTS:
            end.synchronize()
            full_step_ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.flash_attention.launches,
                "rmsnorm": RN.rmsnorm.launches}   # the serving path ends here
    check(all(r.status == DONE and len(r.output) == LM_NEW for r in reqs)
          and not srv.rejected and not srv.abandoned,
          f"served {sum(r.status == DONE for r in reqs)}/{LM_REQUESTS}, "
          f"rejected {len(srv.rejected)}, abandoned {len(srv.abandoned)}")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.output),
          "generated token out of the vocabulary")
    check(launches["flash_attention"] == cfg.n_layers * prefills
          and launches["rmsnorm"] == norms * (prefills + decodes),
          f"serving launch counts {launches}")
    tokens = sum(len(r.output) for r in reqs)
    log(f"[serve] {LM_ARCH} bf16, {LM_SLOTS} slots, max_len {LM_MAX_LEN}: "
        f"{LM_REQUESTS}/{LM_REQUESTS} done, 0 rejected, 0 abandoned; "
        f"{prefills} prefills, {decodes} decode steps; launches {launches}: "
        f"flash {cfg.n_layers} and rmsnorm {norms} a prefill, rmsnorm "
        f"{norms} and flash 0 a decode step")
    bins = {}
    for r in reqs:
        lo = next(b for b in PREFILL_BINS[::-1] if len(r.prompt) >= b)
        bins.setdefault(lo, []).append(r.prefill_s * 1e3)
    prefill_ms = {f">={lo}": (float(np.mean(v)), len(v))
                  for lo, v in sorted(bins.items())}
    step_ms = float(np.mean(full_step_ms)) if full_step_ms else None
    log(f"[serve] {tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
        f"generated tokens/s; mean prefill ms by prompt length "
        f"{ {k: round(v[0], 3) for k, v in prefill_ms.items()} } (requests "
        f"{ {k: v[1] for k, v in prefill_ms.items()} }); decode step with "
        f"{LM_SLOTS} active slots {step_ms:.3f} ms (mean of "
        f"{len(full_step_ms)}, CUDA events)")
    return {"launches": launches, "prefills": prefills, "decodes": decodes,
            "prompt_lens": [int(n) for n in lens], "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_ms_by_len": prefill_ms, "decode_step_ms": step_ms,
            "decode_steps_timed": len(full_step_ms)}


def profile_runs(runs: dict) -> dict:
    """``torch.profiler`` over each named (reps, fn) after one warm-up
    call, the reps ending in a synchronize: host wall ms, device busy ms
    (the CUDA kernels' summed durations), the device's idle share, kernels
    launched, the port's own kernels' device ms, and the top kernels, per
    rep.  If the profiler records no device time the run says "not
    measured" and the smoke run goes on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (reps, fn) in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
        if not kernels or busy_ms <= 0:
            log(f"[profile] {name}: device time not measured (the profiler "
                f"recorded no CUDA kernel); host wall {wall_ms:.3f} ms")
            continue
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.elapsed_us() / 1e3 / reps)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        port_ms = sum(v for k, v in by_name.items()
                      if any(p in k for p in PORT_KERNEL_NAMES))
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / wall_ms,
                     "kernels": len(kernels) / reps, "port_kernels_ms": port_ms,
                     "top": [(k[:60], v) for k, v in top]}
        log(f"[profile] {name}: host wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / wall_ms):.1f}%), "
            f"{len(kernels) / reps:.0f} kernels, the port's kernels "
            f"{port_ms:.3f} ms; top by device time: "
            + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
    return out


def phase_profile_serve(dev, params, cfg) -> dict:
    """Where a serving step's time goes (:func:`profile_runs`): one
    prefill of the longest prompt, and 4 decode steps of 8 slots at
    position 512."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    toks = torch.as_tensor(np.arange(LM_PROMPT[1]) % cfg.vocab,
                           device=dev)[None]
    cache = T.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    cache["pos"][:] = 512
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    runs = {"prefill": (1, lambda: T.prefill(params, {"tokens": toks}, cfg,
                                             LM_MAX_LEN)),
            "decode_step": (4, lambda: T.decode_step(params, cache, last,
                                                     cfg))}
    return profile_runs(runs)


def bound(t_ops, t_bytes) -> dict:
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def time_rmsnorm(randn, rows, d) -> dict:
    """The RMSNorm kernel at (rows, d) from ``randn``: kernel and
    ``F.rms_norm`` by device_ms, the plain version by CUDA events, and the
    bound (each input read once, the output written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    x, w = randn(rows, d), randn(d)
    return {"shape": [rows, d],
            "ms": device_ms(lambda: RN.rmsnorm(x, w)),
            "plain_ms": cuda_ms(lambda: RN.rmsnorm_plain(x, w), reps=3),
            "library_ms": device_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            **bound(4.0 * rows * d / FP32_FLOPS * 1e3,
                    2.0 * (2 * rows * d + d) / HBM_BYTES_PER_S * 1e3)}


def log_row(name, r, launches=None) -> None:
    extra = (f" run={r['run']} {r['tflops']:.2f} TFLOP/s,"
             if "run" in r else "")
    times = "" if launches is None else f" x{launches} launches"
    log(f"[time] {name} {r['shape']} bf16{times}:{extra} kernel "
        f"{r['ms']:.4f} ms, library {r['library_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; the kernel at "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)")


def time_rmsnorm_floor_and_host(randn, d) -> dict:
    """What a small RMSNorm launch cannot go below, and what its wrapper
    costs the host, in bf16: the kernel and ``F.rms_norm`` at
    NORM_FLOOR_SHAPE by device_ms (a launch with almost no work: the floor
    of a kernel replayed in a CUDA graph), and the host microseconds a
    call at (LM_SLOTS, d), kernel and ``F.rms_norm``: a host clock around
    NORM_HOST_CALLS calls, ended by a synchronize."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    rows, width = NORM_FLOOR_SHAPE
    x, w = randn(rows, width), randn(width)
    out = {"floor_shape": [rows, width],
           "floor_ms": device_ms(lambda: RN.rmsnorm(x, w)),
           "floor_library_ms": device_ms(
               lambda: F.rms_norm(x, (width,), w, 1e-6))}
    x, w = randn(LM_SLOTS, d), randn(d)

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NORM_HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / NORM_HOST_CALLS

    out["host_shape"] = [LM_SLOTS, d]
    out["host_us"] = host_us(lambda: RN.rmsnorm(x, w))
    out["library_host_us"] = host_us(lambda: F.rms_norm(x, (d,), w, 1e-6))
    log(f"[time] rmsnorm floor {out['floor_shape']} bf16 (device_ms): "
        f"kernel {out['floor_ms']:.4f} ms, F.rms_norm "
        f"{out['floor_library_ms']:.4f} ms")
    log(f"[time] rmsnorm host cost a call at {out['host_shape']} bf16 "
        f"(host clock over {NORM_HOST_CALLS} calls, ended by a "
        f"synchronize): wrapper {out['host_us']:.2f} us, F.rms_norm "
        f"{out['library_host_us']:.2f} us")
    return out


def phase_time_lm_kernels(dev, cfg, serve) -> tuple:
    """Each LM kernel at the serving path's shapes, bf16: kernel and one
    PyTorch call by device_ms, the plain version by CUDA events, and the
    bound.  A kernel's totals are over the serving run's launches: each
    shape's times multiplied by its launches there (every prompt length
    for prefill, (8, d_model) rows for the decode steps' norms).  The
    canonical shapes (flash at S 256, 1024, 2048; RMSNorm at 1024 rows)
    are logged too.  Returns the kernels' totals and the RMSNorm floor
    and host cost (:func:`time_rmsnorm_floor_and_host`)."""
    import collections
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    dt, d = torch.bfloat16, cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    randn = lambda *shape: torch.randn(shape, generator=gen,
                                       device=dev).to(dt)

    rmsnorm_row = lambda rows: time_rmsnorm(randn, rows, d)

    def flash_row(s) -> dict:
        q, k, v = randn(1, s, hq, hd), randn(1, s, hkv, hd), randn(1, s, hkv,
                                                                   hd)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        geom = FA.legalize(128, 128, s, hd, dt)
        flops = 2.0 * hq * hd * s * (s + 1)  # 2 GEMMs over S(S+1)/2 pairs
        row = {"shape": [1, s, hq, hkv, hd],
               "run": [geom.bq, geom.bk, geom.dp],
               "ms": device_ms(lambda: FA.flash_attention(q, k, v)),
               "plain_ms": cuda_ms(lambda: FA.flash_attention_plain(
                   q, k, v, True, None, hd ** -0.5, geom), reps=1),
               "library_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)),
               **bound(flops / BF16_FLOPS * 1e3,
                       2.0 * s * hd * (2 * hq + 2 * hkv)
                       / HBM_BYTES_PER_S * 1e3)}
        row["tflops"] = flops / row["ms"] / 1e9
        return row

    norms = 2 * cfg.n_layers + 1
    counts = {"rmsnorm": collections.Counter(), "flash_attention":
              collections.Counter()}
    for n in serve["prompt_lens"]:
        counts["rmsnorm"][n] += norms
        counts["flash_attention"][n] += cfg.n_layers
    counts["rmsnorm"][LM_SLOTS] += norms * serve["decodes"]
    kernels = []
    for name, row_fn in (("rmsnorm", rmsnorm_row),
                         ("flash_attention", flash_row)):
        cnt = counts[name]
        check(sum(cnt.values()) == serve["launches"][name],
              f"{name}: timed shapes cover {sum(cnt.values())} launches, "
              f"the run made {serve['launches'][name]}")
        rows = {n: row_fn(n) for n in sorted(cnt)}
        for n, r in rows.items():
            log_row(name, r, cnt[n])
        tot = {key: sum(rows[n][key] * cnt[n] for n in rows)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(rows[n]["bound_ms"] * cnt[n] for n in rows
                     if rows[n]["bound_by"] == "operations")
        tot["bound_by"] = ("operations" if 2 * by_ops >= tot["bound_ms"]
                           else "bytes")
        tot["launches"] = serve["launches"][name]
        tot["shapes"] = [dict(r, launches=cnt[n]) for n, r in rows.items()]
        log(f"[time] {name} over the serving run's {tot['launches']} "
            f"launches: kernel {tot['ms']:.3f} ms, library "
            f"{tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.1f} ms, "
            f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
        kernels.append((name, tot))
    for s in FLASH_TIMED_S:
        log_row("flash_attention", flash_row(s))
    log_row("rmsnorm", rmsnorm_row(NORM_TIMED_ROWS))
    return kernels, time_rmsnorm_floor_and_host(randn, d)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (fails here, before any result)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    card = phase_card()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_s = phase_build()
    check_err = phase_check_kernel(dev)
    lm_check_err = phase_check_lm_kernels(dev)
    from repro_torch.kernels import gemm as G
    G.gemm.launches = 0  # the main path (tune -> deploy) starts here
    rep, tune_s = phase_tune(dev)
    launches, fwd_err, fwd_ms, plain_fwd_ms, per_shape = phase_deploy(dev, rep)
    episode_ms = phase_episode_time(dev)
    rows = phase_time_shapes(dev, per_shape)
    baselines, base_s = timed(lambda: phase_baselines(dev, rep, tune_s))
    log(f"[baselines] phase {base_s:.1f} s")
    (coopt, netopt), net_s = timed(lambda: phase_netopt(dev))
    log(f"[netopt] phase {net_s:.1f} s")
    netopt_deploy, dep_s = timed(lambda: phase_netopt_deploy(
        dev, coopt, fwd_ms, plain_fwd_ms, rows))
    log(f"[netopt deploy] phase {dep_s:.1f} s")
    lm_params, lm_cfg, lm_rel32, lm_rel16 = phase_lm_gate(dev)
    serve = phase_serve(dev, lm_params, lm_cfg)   # resets the LM counts
    profile = phase_profile_serve(dev, lm_params, lm_cfg)
    lm_kernels, norm_floor = phase_time_lm_kernels(dev, lm_cfg, serve)

    # one forward's GEMM work: every shape times the layers that run it
    total = lambda key: sum(r[key] * r["layers"] for r in rows)
    t_ops = sum(2.0 * r["M"] * r["N"] * r["K"] * r["layers"]
                for r in rows) / FP32_FLOPS * 1e3
    t_bytes = sum(4.0 * (r["M"] * r["K"] + r["K"] * r["N"] + r["M"] * r["N"])
                  * r["layers"] for r in rows) / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"card": card, "build_s": build_s, "tune_s": tune_s,
                    "mappo_episode_ms": episode_ms, "forward_ms": fwd_ms,
                    "forward_plain_ms": plain_fwd_ms,
                    "forward_logits_max_abs_err": fwd_err,
                    "gemm_shapes": rows,
                    "baselines": baselines, "netopt": netopt,
                    "netopt_deploy": netopt_deploy,
                    "phase_s": {"baselines": base_s, "netopt": net_s,
                                "netopt_deploy": dep_s},
                    "lm": {"arch": LM_ARCH, "dtype": "bfloat16",
                           "logits_rel_err_fp32": lm_rel32,
                           "logits_rel_err_bf16": lm_rel16,
                           "flash_vs_fp32_p_max_abs_err":
                               lm_check_err["flash_vs_fp32_p"],
                           **{k: v for k, v in serve.items()
                              if k != "launches"},
                           "profile": profile,
                           "kernels": dict(lm_kernels),
                           "rmsnorm_floor_and_host": norm_floor}}))
    sources = {"rmsnorm": "src/repro/kernels/rmsnorm.py:21",
               "flash_attention": "src/repro/kernels/flash_attention.py:29"}
    log(json.dumps({"kernels": [{
        "name": "gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:48",
        "launches": launches,
        "max_abs_err": check_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"),
        "device_ms": total("device_ms"),
        "library_device_ms": total("library_device_ms"),
        "netopt_deploy_launches": netopt_deploy["launches"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": sources[name],
        "launches": tot["launches"],
        "max_abs_err": lm_check_err[name],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"],
        "library_ms": tot["library_ms"],
    } for name, tot in lm_kernels]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
