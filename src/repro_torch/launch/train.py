"""Training launcher (the reference's ``repro.launch.train`` on one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 20 [--device cpu]

Runs the fault-tolerant ``Trainer`` on ``cuda`` unless ``--device`` names
another device; without CUDA and without ``--device cpu`` it raises.
Prints the model line, then the reference's JSON (``first_loss``,
``last_loss``, ``steps``, ``wall_s``, ``tokens_per_s``).  A checkpoint
directory that already holds a run resumes it.  ``--data``/``--model``
mesh axes other than 1 wait for the device mesh (ROADMAP Queue 1, item
16) and raise.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataConfig
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
    if args.data != 1 or args.model != 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: training over a "
            f"device mesh is not ported yet (ROADMAP Queue 1, item 16)")
    device = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=args.reduced)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                     total_steps=args.steps, grad_accum=args.grad_accum)
    trc = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=args.ckpt_every,
                        log_every=max(args.steps // 50, 1))
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    trainer = Trainer(cfg, tc, trc, device=device, data_cfg=dc)

    n = param_count(trainer.params)
    print(f"arch={cfg.name} params={n/1e6:.1f}M device={device} "
          f"batch={args.batch}x{args.seq}", flush=True)
    t0 = time.time()
    log = trainer.run()
    dt = time.time() - t0
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
