"""Quickstart: co-optimize one convolution with ARCO and deploy the result,
on the PyTorch port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. builds the 7-knob design space (Table 2) for a ResNet-style conv;
2. runs the MAPPO+CS tuning loop against the TPU latency oracle (the
   analytical model; the agents run on ``--device``, default cuda);
3. compares against the software-only baselines;
4. executes the tuned configuration through the GEMM core — on cuda the
   Hopper kernel (``kernels/csrc/gemm.cu``), on the CPU its plain version —
   and checks it against the plain conv oracle (``kernels/ref.conv2d_ref``),
   printing the GEMM's launches beside the error.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import mappo
from repro_torch.core.baselines import autotvm_tune, random_tune
from repro_torch.core.design_space import KNOB_NAMES, DesignSpace
from repro_torch.core.tuner import TunerConfig, arco_tune
from repro_torch.hw.analytical import conv2d_gflops, conv2d_min_latency
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops, ref

WORKLOAD = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)


def tuner_config() -> TunerConfig:
    return TunerConfig(iteration_opt=6, b_measure=48, episodes_per_iter=3,
                       mappo=mappo.MappoConfig(n_steps=64, n_envs=16),
                       gbt_rounds=20)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents, the baselines' "
                         "searches and the deployed conv (default cuda; "
                         "cpu on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workload = WORKLOAD      # the reference's ResNet-style conv
    space = DesignSpace.for_conv2d(workload)
    print(f"design space: {space.size} configurations "
          f"({len(KNOB_NAMES)} knobs)")

    cfg = tuner_config()

    t0 = time.time()
    result = arco_tune(space, cfg, device=dev)
    print(f"\nARCO:    best latency {result.best_latency * 1e6:9.2f} us  "
          f"({conv2d_gflops(workload, result.best_latency):7.1f} GFLOP/s)  "
          f"[{result.n_measurements} measurements, "
          f"{time.time() - t0:.1f}s]")
    out = {"arco_latency_s": result.best_latency}

    for name, key, fn in (("AutoTVM*", "autotvm", autotvm_tune),
                          ("random", "random", random_tune)):
        r = fn(space, cfg, device=dev)
        out[f"{key}_latency_s"] = r.best_latency
        print(f"{name:8s} best latency {r.best_latency * 1e6:9.2f} us  "
              f"({conv2d_gflops(workload, r.best_latency):7.1f} GFLOP/s)  "
              f"[hardware knobs frozen at default geometry]")
    out["min_latency_s"] = conv2d_min_latency(workload)
    print(f"roofline lower bound: "
          f"{out['min_latency_s'] * 1e6:.2f} us")

    vals = space.values(torch.as_tensor(result.best_config)).cpu().numpy()
    named = dict(zip(KNOB_NAMES, vals.astype(int).tolist()))
    print(f"\ntuned configuration: {named}")

    x = torch.randn((1, 14, 14, 256), generator=torch.Generator(
        dev).manual_seed(0), device=dev)
    w = torch.randn((3, 3, 256, 256), generator=torch.Generator(
        dev).manual_seed(1), device=dev)
    launches = G.gemm.launches
    got = ops.conv2d_from_knobs(
        x, w, 1, 1, tile_b=named["tile_b"], tile_h=named["tile_h"],
        tile_w=named["tile_w"], tile_ci=named["tile_ci"],
        tile_co=named["tile_co"], h_threading=named["h_threading"],
        oc_threading=named["oc_threading"])
    launches = G.gemm.launches - launches
    want = ref.conv2d_ref(x, w, 1, 1)
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    where = ("the Hopper GEMM (kernels/csrc/gemm.cu)" if dev.type == "cuda"
             else f"the GEMM's plain version ({dev.type})")
    print(f"deployed through {where}: max |err| vs oracle = {err:.2e} "
          f"(max |oracle| {peak:.2e}; {launches} GEMM launches)")
    out.update(config=named, deploy_max_abs_err=err, oracle_max_abs=peak,
               gemm_launches=launches)
    return out


if __name__ == "__main__":
    main()
