"""End-to-end LM training driver on the PyTorch port: real data pipeline,
fault-tolerant trainer, checkpoints — reduced smollm-360m by default,
--full for the published ~360M config.  On cuda every norm of the forward
(and of its recompute under remat) runs the Hopper RMSNorm kernel.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full --steps 100
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
"""
import argparse
import json
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.transformer import param_count
from repro_torch.train.steps import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="full smollm-360m (heavy on CPU)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu on "
                         "request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smollm-360m", reduced=not args.full)
    batch = args.batch or (4 if args.full else 8)
    seq = args.seq or (512 if args.full else 128)

    # one device, no mesh (the reference's make_host_mesh(1, 1))
    tc = TrainConfig(lr=1e-3, warmup_steps=args.steps // 10,
                     total_steps=args.steps)
    with tempfile.TemporaryDirectory() as ckpt:
        trc = TrainerConfig(steps=args.steps, ckpt_dir=ckpt,
                            ckpt_every=max(args.steps // 4, 10),
                            log_every=max(args.steps // 20, 1))
        dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                        structure=64)
        trainer = Trainer(cfg, tc, trc, device=dev, data_cfg=dc)
        print(f"model: smollm-360m{'' if args.full else ' (reduced)'} — "
              f"{param_count(trainer.params) / 1e6:.1f}M params, "
              f"batch {batch}x{seq}")
        t0 = time.time()
        log = trainer.run()
        dt = time.time() - t0
    losses = [e for e in log if "loss" in e]
    out = {
        "first_loss": round(losses[0]["loss"], 4),
        "last_loss": round(losses[-1]["loss"], 4),
        "steps": trainer.step,
        "tokens_per_s": round(trainer.step * batch * seq / dt)}
    print(json.dumps(out, indent=1))
    assert losses[-1]["loss"] < losses[0]["loss"], "training must learn"
    return out


if __name__ == "__main__":
    main()
