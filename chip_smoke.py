#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path on ``cuda:0``, the paper's own loop at full
ResNet-18 width:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the Hopper GEMM kernel from ``src/repro_torch/kernels/csrc``;
3. holds the kernel against its plain PyTorch version on the card: the
   reference test shapes and configs (fp32 and bf16), and the 8 ResNet-18
   im2col shapes at batch 8 under the default and knob-derived configs;
4. tunes the 8 ResNet-18 conv tasks (batch 8) with the port's ``Session``;
5. deploys: runs ResNet-18 at 224x224, batch 8, fp32, seeded weights, each
   conv layer through the kernel with its tuned geometry, and compares the
   logits with the plain path (cuDNN fp32 convolutions, TF32 off); the
   kernel's launch counter must rise by exactly 17 in that forward;
6. times each main-path GEMM shape (kernel, plain version, one
   ``torch.matmul`` call as a yardstick, and the card's bound) and the
   forward, and prints one JSON line with the kernel table.

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
FORWARD_TOL = 1e-4        # max |logit diff| / max |logit|, as the CPU tests
REFERENCE_SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
                    (257, 129, 65)]
REFERENCE_CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
                     (16, 64, 128, False, True), (8, 128, 256, True, False)]


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
    from repro_torch.kernels import gemm as G
    t0 = time.perf_counter()
    path = G.build()
    dt = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(path, ROOT)} in {dt:.1f} s")
    return dt


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
            log(f"[check] {name} M={m} N={n} K={k} run={run} "
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


def phase_deploy(dev, rep):
    """Full-width ResNet-18 forward with tuned per-layer geometries; reads
    the kernel's launch count right after the first forward (the count was
    set to 0 before tuning, where the main path starts)."""
    import torch
    from repro_torch.kernels import gemm as G
    from repro_torch.models import cnn
    from repro_torch.core.task import conv_tasks
    specs = cnn.conv_specs("resnet-18")
    layer_task = {}
    for t in conv_tasks("resnet-18", batch=BATCH):
        for layer in t.layer_names:
            layer_task[layer] = t.name
    configs = [knob_config(rep[layer_task[s.name]].best_settings, s)
               for s in specs]
    net = cnn.init_params(SEED, "resnet-18", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
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
    per_shape = {}
    for s, cfg in zip(specs, configs):
        per_shape.setdefault(layer_task[s.name], cfg)
    return launches, diff, fwd_ms, plain_fwd_ms, per_shape


def phase_time_shapes(dev, per_shape):
    """Per-shape kernel / plain / library times and bounds at batch 8."""
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
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), reps=20)
        plain_ms = cuda_ms(lambda: G.gemm_plain(a, b, geom), reps=1)
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n)
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row = {"task": name, "M": m, "N": n, "K": k, "layers": layers,
               "run": [geom.bm, geom.bn, geom.bk],
               "requested": [cfg.block_m, cfg.block_n, cfg.block_k],
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / ms / 1e9}
        rows.append(row)
        log(f"[time] {name} M={m} N={n} K={k} x{layers} run={row['run']} "
            f"kernel {ms:.4f} ms ({row['tflops']:.2f} TFLOP/s), "
            f"torch.matmul {lib_ms:.4f} ms, plain {plain_ms:.1f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


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
    from repro_torch.kernels import gemm as G
    G.gemm.launches = 0  # the main path (tune -> deploy) starts here
    rep, tune_s = phase_tune(dev)
    launches, fwd_err, fwd_ms, plain_fwd_ms, per_shape = phase_deploy(dev, rep)
    episode_ms = phase_episode_time(dev)
    rows = phase_time_shapes(dev, per_shape)

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
                    "gemm_shapes": rows}))
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
    }]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
