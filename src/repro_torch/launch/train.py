"""Training launcher (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 20 [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-1.5b --reduced --steps 20 --data 2 --model 2

Runs the fault-tolerant ``Trainer`` on ``cuda`` unless ``--device`` names
another device; without CUDA and without ``--device cpu`` it raises.
Prints the model line, then the reference's JSON (``first_loss``,
``last_loss``, ``steps``, ``wall_s``, ``tokens_per_s``).  A checkpoint
directory that already holds a run resumes it.

``--data D --model M`` trains over a (data, model) ``DeviceMesh`` of
D x M processes, one per device, started by ``torchrun`` (rank, world
size and the rendezvous come from its environment; NCCL on ``cuda``, each
rank on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``).  It raises
unless D x M equals the world size.  Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.sharding import mesh_shape
from repro_torch.launch.mesh import backend_for, describe, make_device_mesh
from repro_torch.models.transformer import param_count
from repro_torch.train.steps import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=TrainerConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.data * args.model != world:
        raise ValueError(
            f"--data {args.data} --model {args.model} needs "
            f"{args.data * args.model} processes, the world size is {world} "
            f"(start it with torchrun --nproc-per-node "
            f"{args.data * args.model})")
    device = resolve_device(args.device)
    mesh = None
    if world > 1:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device))
        mesh = make_device_mesh({"data": args.data, "model": args.model},
                                device)
    try:
        _train(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, device, mesh) -> None:
    cfg = get_config(args.arch, reduced=args.reduced)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                     total_steps=args.steps, grad_accum=args.grad_accum)
    trc = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=args.ckpt_every,
                        log_every=max(args.steps // 50, 1))
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    trainer = Trainer(cfg, tc, trc, device=device, data_cfg=dc, mesh=mesh)
    lead = mesh is None or mesh.get_rank() == 0

    n = param_count(trainer.params)
    where = (f"device={device}" if mesh is None else
             f"device={device.type} mesh={describe(mesh_shape(mesh))}")
    if lead:
        print(f"arch={cfg.name} params={n/1e6:.1f}M {where} "
              f"batch={args.batch}x{args.seq}", flush=True)
    t0 = time.time()
    log = trainer.run()
    dt = time.time() - t0
    if not lead:
        return
    losses = [e for e in log if "loss" in e]
    print(json.dumps({"first_loss": losses[0]["loss"],
                      "last_loss": losses[-1]["loss"],
                      "steps": trainer.step,
                      "wall_s": round(dt, 1),
                      "tokens_per_s": round(
                          trainer.step * args.batch * args.seq / dt)},
                     indent=1))


if __name__ == "__main__":
    main()
