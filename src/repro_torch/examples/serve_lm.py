"""Batched serving demo on the PyTorch port: continuous-batching slots,
per-sequence depths, the reduced config of ``--arch`` with seeded random
weights.  On cuda every norm runs the Hopper RMSNorm kernel and every
prefill's attention the flash kernel.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda; cpu on "
                         "request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    params = T.init_params(0, cfg, device=dev)
    srv = Server(params, cfg, n_slots=args.slots, max_len=128)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        srv.submit(Request(
            uid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(4, 20))).astype(
                np.int32),
            max_new_tokens=args.max_new))
    t0 = time.time()
    done = sorted(srv.run_until_drained(), key=lambda r: r.uid)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    for r in done:
        print(f"req {r.uid}: prompt[{len(r.prompt)}] -> "
              f"{r.output[:8]}{'...' if len(r.output) > 8 else ''} "
              f"({r.latency_s:.2f}s)")
    print(f"\n{len(done)} requests, {toks} tokens, "
          f"{toks / dt:.1f} tok/s with {args.slots} slots")
    return {"done": done, "tokens": toks, "wall_s": dt,
            "rejected": len(srv.rejected), "abandoned": len(srv.abandoned)}


if __name__ == "__main__":
    main()
