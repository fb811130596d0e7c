"""Multi-pod dry-run estimator: one JSON artifact per (arch x shape x mesh)
cell, with no device touched.

The port of the reference's ``repro.launch.dryrun``.  The reference lowers
and compiles each cell's sharded step for 512 placeholder host devices and
reads the compiled program; the port has no compiler to ask, so for every
cell it prices the placement decisions of ``repro_torch.dist.sharding`` on
a mesh shape (``launch.mesh.make_dryrun_mesh``) and runs the port's own
step on the ``meta`` device (``repro_torch.hw.step_analysis``):

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun

``--devices N`` (default ``REPRO_DRYRUN_DEVICES``, else 512) stands in for
the reference's placeholder device count.  Nothing runs on a GPU or the
CPU's memory: every tensor is a ``meta`` tensor.

The artifact keeps the reference's keys.  ``status`` is ok / skipped
(``cell_supported``'s long-context rule) / error; ``weighted`` holds the
per-device ``dot_flops_per_device``, ``collective_bytes_by_op`` and
``wire_bytes_per_device``.  The memory keys are estimates, a device's
bytes:
  * ``argument_size_in_bytes``: the step's inputs under their placements:
    the parameters (``param_bytes_per_device``), for training Adam's two
    moments placed as the parameters, the batch's share, for decode the
    cache's share (``cache_shardings``);
  * ``output_size_in_bytes``: what the step hands back: the updated
    parameters and moments (training), or the last logits (vocab-sharded
    by the LM head's placement) and the decode cache;
  * ``temp_size_in_bytes``: the peak bytes of the tensors the counted run
    allocates on ``meta`` (each divided by its model-axis factor), carried
    to the full depth (and a recurrent family's ``seq``) as the FLOPs are;
  * ``param_bytes_global``: every parameter's bytes, unsharded.
``compile_s`` is the analysis's seconds.  Keys the port's artifact lacks,
because they are products of XLA's compiler: ``collectives`` (the
reference's ``collective_stats``, raw collective bytes parsed from HLO
with loop bodies counted once) and ``trip_counts``
(``_while_trip_counts``, the HLO's while-loop trip counts); also
``cost_flops``/``cost_bytes`` (XLA's ``cost_analysis``),
``generated_code_size_in_bytes`` and ``hlo_chars``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, cell_supported, input_specs
from repro_torch.dist import sharding as SH
from repro_torch.hw import step_analysis
from repro_torch.launch.mesh import describe, make_dryrun_mesh
from repro_torch.models import transformer as T


def default_devices() -> int:
    """The placeholder device count: ``REPRO_DRYRUN_DEVICES``, else 512."""
    return int(os.environ.get("REPRO_DRYRUN_DEVICES", "512"))


def _bytes(tree) -> int:
    return sum(int(np.prod(t.shape)) * t.element_size()
               for t in SH.tree_leaves(tree))


def memory_estimate(cfg, shape, mesh: SH.Mesh, rules: SH.ShardingRules,
                    b_loc: int, moment_bytes: int = 2) -> Dict[str, int]:
    """The artifact's argument and output bytes a device (module
    docstring)."""
    params = T.abstract_params(cfg)
    psh = SH.param_shardings(params, mesh, cfg, rules)
    p_bytes = SH.param_bytes_per_device(params, psh)
    spec = input_specs(cfg, shape, batch_override=b_loc)
    if shape.kind == "train":
        n_local = sum(
            int(np.prod(t.shape)) // SH.shard_factor(s)
            for t, s in zip(SH.tree_leaves(params), SH.tree_leaves(psh)))
        moments = 2 * n_local * moment_bytes
        batch = _bytes(spec)
        return {"argument_size_in_bytes": p_bytes + moments + batch,
                "output_size_in_bytes": p_bytes + moments}
    m = SH.axis_size(mesh, psh["lm_head"].spec[1])
    logits = b_loc * cfg.vocab // m * 4
    cache = (T.init_cache(cfg, b_loc, shape.seq, device="meta")
             if shape.kind == "prefill" else spec["cache"])
    c_bytes = SH.param_bytes_per_device(
        cache, SH.cache_shardings(cache, mesh, cfg, rules))
    if shape.kind == "prefill":     # the cache is an output only
        return {"argument_size_in_bytes": p_bytes + _bytes(spec),
                "output_size_in_bytes": logits + c_bytes}
    return {"argument_size_in_bytes": p_bytes + c_bytes
            + _bytes(spec["tokens"]),
            "output_size_in_bytes": logits + c_bytes}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             batch_override: Optional[int] = None,
             rules: Optional[SH.ShardingRules] = None,
             n_devices: Optional[int] = None) -> Dict[str, Any]:
    """One cell's artifact (module docstring), emitted to ``out_dir``."""
    rules = rules or SH.ShardingRules()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_dryrun_mesh(n_devices or default_devices(),
                            multi_pod=multi_pod)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_desc": describe(mesh), "kind": shape.kind,
    }

    ok, reason = cell_supported(cfg, shape)
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        _emit(result, out_dir)
        return result

    t0 = time.time()
    try:
        a = step_analysis.analyze(cfg, shape, mesh, rules,
                                  batch=batch_override)
        result.update(memory_estimate(cfg, shape, mesh, rules,
                                      a["batch_per_device"]))
        result["temp_size_in_bytes"] = int(a["temp_bytes"])
        result["weighted"] = {
            "dot_flops_per_device": a["weighted_dot_flops"],
            "collective_bytes_by_op": a["collective_bytes_by_op"],
            "wire_bytes_per_device": a["wire_bytes_per_device"],
        }
        result["n_ops"] = a["n_ops"]
        result["counted"] = {"seq": a["counted_seq"],
                             "layers": a["counted_layers"],
                             "exact": a["exact"],
                             "batch_per_device": a["batch_per_device"]}
        result["param_bytes_global"] = _bytes(T.abstract_params(cfg))
        result["compile_s"] = round(time.time() - t0, 2)
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    _emit(result, out_dir)
    return result


def _emit(result: Dict[str, Any], out_dir: Optional[str]):
    line = (f"[{result['mesh']}] {result['arch']} x {result['shape']}: "
            f"{result['status']}")
    if result["status"] == "ok":
        coll = result["weighted"]["wire_bytes_per_device"]
        line += (f"  dotF/dev={result['weighted']['dot_flops_per_device']:.3e}"
                 f" tempB={result.get('temp_size_in_bytes', 0):.3e}"
                 f" collB/dev={coll:.3e}"
                 f" compile={result['compile_s']}s")
    elif result["status"] == "skipped":
        line += f"  ({result['reason'][:60]}...)"
    else:
        line += f"  {result['error'][:200]}"
    print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = (f"{result['arch']}__{result['shape']}__"
                 f"{result['mesh']}.json")
        result = dict(result)
        result.pop("traceback", None)
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="override global batch (debug)")
    ap.add_argument("--devices", type=int, default=None,
                    help="placeholder device count (default "
                         "REPRO_DRYRUN_DEVICES, else 512)")
    ap.add_argument("--sp", action="store_true",
                    help="optimized rules: Megatron-style sequence "
                         "parallelism on the residual stream")
    args = ap.parse_args(argv)
    rules = SH.ShardingRules(sequence_parallel=args.sp)

    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    n_bad = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mp, args.out, args.batch,
                             rules=rules, n_devices=args.devices)
                n_bad += r["status"] == "error"
    print(f"done; {n_bad} errors", flush=True)
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
