"""Dev tool: list the largest per-device tensors of a dry-run cell's step.

    PYTHONPATH=src python -m repro_torch.tools.profile_hlo \
        --arch jamba-1.5-large-398b --shape train_4k --multipod --min-gb 0.3

The port of the reference's ``tools/profile_hlo.py``, with its flags and
its printed lines.  The reference compiles the cell's sharded step for
``REPRO_DRYRUN_DEVICES`` placeholder devices and groups the compiled
HLO's per-partition tensors by (op, dtype, dims), then prints XLA's temp
and argument bytes.  The port compiles no HLO: it runs the cell's step
(train, prefill or decode) once, at full depth, on the ``meta`` device as
the dry-run estimator counts it (``hw.step_analysis._count`` with its
counter's record), and groups:

* every tensor an op of the step returns (a view's too, as the
  reference's listing counts its bitcasts), a device's share of it, by
  (aten op, dtype, dims).  Dims are at the per-device batch; a tensor the
  model axis splits (the factor ``ShardedFlopCounter`` carries from a
  sharded weight) shows its whole dims followed by ``/f``, since the
  counter does not track which dim the axis splits;
* the step's inputs as ``parameter``, as the HLO lists its entry
  parameters: the parameters, for training Adam's two moments (in each
  parameter's dtype, as ``TrainConfig()`` keeps them), the batch, for
  decode the cache, each at its dims on one device under its placement.
  The port keeps one tensor a layer where the reference stacks a period
  position's layers into one array for its scan, so a layer weight's
  group counts ``n_layers`` tensors here and one there.

A group is left out where each of its tensors is below ``--min-gb`` GB;
the 20 largest by bytes are printed, then ``temp GB`` (the counter's peak
of live bytes) and ``args GB`` (``launch.dryrun.memory_estimate``).  Op
names and temp bytes model PyTorch's eager allocations, not XLA's fused
buffers; the output says so once.  ``--dump PATH`` writes every group.
The placeholder device count is ``REPRO_DRYRUN_DEVICES`` (default 512:
``launch.dryrun.default_devices``).  Nothing touches a device: every
tensor is a ``meta`` tensor (the step takes seconds; a recurrent
family's train or prefill step, one Python step a token and layer,
minutes at 4,096 tokens).
"""
from __future__ import annotations

import argparse
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.dist import sharding as SH
from repro_torch.hw import step_analysis as SA
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.models import transformer as T
from repro_torch.train import steps as S

# the reference's dtype names (XLA's)
DT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
      torch.bool: "pred", torch.int32: "s32", torch.int64: "s64",
      torch.int8: "s8", torch.uint8: "u8"}
TOP = 20
NOTE = ("# op names and temp bytes model PyTorch's eager allocations on "
        "meta (aten ops, a device's share), not XLA's buffers; /f: a "
        "tensor the model axis splits f ways")

Group = Tuple[str, str, Tuple[int, ...], int]   # op, dtype, dims, factor


def dtype_name(dtype: torch.dtype) -> str:
    return DT.get(dtype, str(dtype).removeprefix("torch."))


def step_inputs(cfg, shape, mesh: SH.Mesh, rules: SH.ShardingRules,
                b_loc: int, tc: S.TrainConfig) -> List[Tuple[Any, ...]]:
    """The step's inputs on one device: [(role, path, dtype, dims)], role
    one of params / mu / nu / batch / cache."""
    params = T.abstract_params(cfg)
    psh = SH.param_shardings(params, mesh, cfg, rules)
    spec = input_specs(cfg, shape, batch_override=b_loc)
    roles = ("params", "mu", "nu") if shape.kind == "train" else ("params",)
    out = []
    for role in roles:
        for (path, t), s in zip(SH._leaves_with_path(params),
                                SH.tree_leaves(psh)):
            dtype = t.dtype if role == "params" else (tc.moment_dtype
                                                      or t.dtype)
            out.append((role, path, dtype, DR.local_dims(t, s)))
    batch = {k: v for k, v in spec.items() if k != "cache"}
    for path, t in SH._leaves_with_path(batch):   # already per device
        out.append(("batch", path, t.dtype, tuple(t.shape)))
    if shape.kind == "decode":
        cache = spec["cache"]
        csh = SH.cache_shardings(cache, mesh, cfg, rules)
        for (path, t), s in zip(SH._leaves_with_path(cache),
                                SH.tree_leaves(csh)):
            out.append(("cache", path, t.dtype,
                        DR.local_dims(t, s, batch_local=True)))
    return out


def profile_cell(arch: str, shape_name: str, multipod: bool = False,
                 grad_accum: int = 1, n_devices: Optional[int] = None
                 ) -> Dict[str, Any]:
    """The cell's groups {(op, dtype, dims, factor): [bytes, count]} a
    device, its temp and argument bytes, the mesh and the per-device
    batch (module docstring)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = SH.ShardingRules()
    mesh = make_dryrun_mesh(n_devices or DR.default_devices(),
                            multi_pod=multipod)
    tc = S.TrainConfig(grad_accum=grad_accum)
    b_loc = SA.local_batch(cfg, shape, mesh, rules)
    record: Dict[Tuple[Any, ...], list] = {}
    counted = SA._count(cfg, shape, mesh, rules, {}, b_loc, record=record,
                        tc=tc)
    groups: Dict[Group, list] = {}
    for (op, dtype, dims, f), (nbytes, n) in record.items():
        g = groups.setdefault((op, dtype_name(dtype), dims, f), [0.0, 0])
        g[0] += nbytes
        g[1] += n
    for _, _, dtype, dims in step_inputs(cfg, shape, mesh, rules, b_loc,
                                         tc):
        g = groups.setdefault(("parameter", dtype_name(dtype), dims, 1),
                              [0.0, 0])
        g[0] += math.prod(dims) * torch.empty((), dtype=dtype).element_size()
        g[1] += 1
    moment = (None if tc.moment_dtype is None
              else torch.empty((), dtype=tc.moment_dtype).element_size())
    args = DR.memory_estimate(cfg, shape, mesh, rules, b_loc, moment)
    return {"groups": groups, "temp_bytes": counted["temp_bytes"],
            "args_bytes": args["argument_size_in_bytes"], "mesh": mesh,
            "batch_per_device": b_loc}


def row(key: Group, nbytes: float, count: int) -> str:
    op, dt, dims, f = key
    split = f"/{f}" if f > 1 else ""
    return (f"{nbytes / 1e9:9.2f} GB  x{count:4d}  {op:24s} "
            f"{dt}[{','.join(map(str, dims))}]{split}")


def largest(groups: Dict[Group, list], min_gb: float,
            top: Optional[int] = TOP) -> List[Tuple[Group, list]]:
    """Groups whose tensors are each at least ``min_gb`` GB, by bytes,
    the ``top`` largest (all with None)."""
    kept = [(k, v) for k, v in groups.items() if v[0] / v[1] >= min_gb * 1e9]
    kept.sort(key=lambda kv: (-kv[1][0], str(kv[0])))
    return kept if top is None else kept[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.profile_hlo")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--min-gb", type=float, default=0.3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    prof = profile_cell(args.arch, args.shape, args.multipod,
                        args.grad_accum)
    if args.dump:
        with open(args.dump, "w") as f:
            f.write(NOTE + "\n")
            for key, (b, c) in largest(prof["groups"], 0.0, None):
                f.write(row(key, b, c) + "\n")
    print(NOTE)
    for key, (b, c) in largest(prof["groups"], args.min_gb):
        print(row(key, b, c))
    print("temp GB:", prof["temp_bytes"] / 1e9,
          " args GB:", prof["args_bytes"] / 1e9)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
