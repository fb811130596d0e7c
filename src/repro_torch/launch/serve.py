"""Serving launcher: continuous-batching decode of synthetic requests.

    # on the GPU (the default device)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --requests 8 --slots 4 --max-len 512

    # on the CPU, at the reduced size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --requests 4 --slots 2 --max-new 4 --device cpu

Submits every request up front and serves until drained (the reference
launcher's ``--rate 0`` mode; its timed arrivals and online tuning wait for
the port of ``serve_tune``).  Weights are random, drawn from ``--seed``.
Every RMSNorm runs through the RMSNorm kernel and prefill attention through
the flash kernel.  Without a GPU and without ``--device cpu`` it raises.

Throughput excludes warm-up: one throwaway request is served before the
timed run.  Rejected and abandoned requests are reported loudly and never
averaged into latency stats (their latency fields are None by design).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server


def _latency_stats(done) -> dict:
    if not done:
        return {"mean_latency_s": None, "p50_latency_s": None,
                "p99_latency_s": None, "mean_queue_s": None,
                "mean_prefill_s": None, "mean_decode_s": None}
    lats = np.asarray([r.latency_s for r in done])
    return {
        "mean_latency_s": round(float(lats.mean()), 4),
        "p50_latency_s": round(float(np.percentile(lats, 50)), 4),
        "p99_latency_s": round(float(np.percentile(lats, 99)), 4),
        "mean_queue_s": round(float(np.mean([r.queue_s for r in done])), 4),
        "mean_prefill_s": round(float(np.mean(
            [r.prefill_s for r in done])), 4),
        "mean_decode_s": round(float(np.mean([r.decode_s for r in done])), 4),
    }


def _warm_up(srv: Server, vocab: int) -> None:
    """Serve one throwaway request so one-time costs (kernel builds and
    loads, library initialisation) land outside the timed run."""
    srv.submit(Request(uid=-1, prompt=np.arange(4, dtype=np.int32) % vocab,
                       max_new_tokens=2))
    srv.run_until_drained(max_steps=64)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="continuous-batching LM server over synthetic requests")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--json-out", metavar="PATH", default=None,
                    help="also write the report JSON here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = T.init_params(args.seed, cfg, device=dev)
    srv = Server(params, cfg, n_slots=args.slots, max_len=args.max_len)
    _warm_up(srv, cfg.vocab)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        srv.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab,
                                size=int(rng.integers(4, 24))).astype(np.int32),
            max_new_tokens=args.max_new))
    done = srv.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    doc = {"arch": cfg.name, "device": str(dev),
           "requests": len(done), "generated_tokens": toks,
           "wall_s": round(dt, 3), "tokens_per_sec": round(toks / dt, 1),
           "rejected": len(srv.rejected), "abandoned": len(srv.abandoned)}
    doc.update(_latency_stats(done))

    # loud, unmissable: these were never served and are NOT in the stats
    for kind, reqs in (("rejected", srv.rejected),
                       ("abandoned", srv.abandoned)):
        if reqs:
            print(f"WARNING: {len(reqs)} request(s) {kind}:")
            for r in reqs[:5]:
                print(f"  uid={r.uid} status={r.status} "
                      f"error={r.error or '-'}")
            if len(reqs) > 5:
                print(f"  ... and {len(reqs) - 5} more")

    out = json.dumps(doc, indent=1)
    print(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(out + "\n")
    return doc


if __name__ == "__main__":
    main()
