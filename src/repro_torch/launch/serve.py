"""Serving launcher: continuous-batching decode of synthetic requests,
optionally with an online tuning session measuring candidate ShardSpace
geometries on idle decode slots (``--autotune``, see
:mod:`repro_torch.compiler.serve_tune`).

    # on the GPU (the default device)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --requests 8 --slots 4 --max-len 512

    # on the CPU, at the reduced size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --requests 4 --slots 2 --max-new 4 --device cpu

    # timed Poisson arrivals + online tuning under a 500 ms p99 SLA
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --requests 16 --rate 20 --autotune --budget 4 --device cpu

``--rate 0`` (default) submits every request up front and serves until
drained.  With ``--rate`` the trace replays Poisson arrivals against the
wall clock (idle gaps fast-forwarded), which is what gives ``--autotune``
idle windows to measure in.  Weights are random, drawn from ``--seed``.
Every ``--arch`` of ``repro_torch.configs`` serves (the port's own
``moonlight-16b-a3b`` too): whisper-base's encoder runs over zero frames
and internvl2-26b's prompts follow zero patches (the frontends are stubs,
as in the reference's server).  Every RMSNorm runs
through the RMSNorm kernel and prefill self attention through the flash
kernel.  Without a GPU and without ``--device cpu`` it raises.

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
from repro_torch.configs import ARCH_NAMES, PORT_ARCH_NAMES, get_config
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
        description="continuous-batching LM server over synthetic "
                    "requests, with optional online geometry tuning")
    ap.add_argument("--arch", choices=ARCH_NAMES + PORT_ARCH_NAMES,
                    default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=0.0, metavar="REQ_PER_S",
                    help="Poisson arrival rate; 0 = submit everything up "
                         "front (drain mode)")
    ap.add_argument("--autotune", action="store_true",
                    help="run an online tuning session on idle decode "
                         "slots while serving (needs --rate > 0)")
    ap.add_argument("--budget", type=int, default=24,
                    help="measurements per tuned cell (--autotune)")
    ap.add_argument("--sla-ms", type=float, default=500.0,
                    help="p99 end-to-end latency SLA in milliseconds")
    ap.add_argument("--records", metavar="PATH", default=None,
                    help="JSONL measurement records for warm resume "
                         "(--autotune)")
    ap.add_argument("--monitor", type=int, default=None, metavar="PORT",
                    help="live /metrics + /status + /trace on this port "
                         "for the duration of the run (0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--json-out", metavar="PATH", default=None,
                    help="also write the report JSON here")
    args = ap.parse_args(argv)
    if args.autotune and args.rate <= 0:
        ap.error("--autotune needs --rate > 0: tuning measures in the "
                 "idle gaps between arrivals, and a fully up-front queue "
                 "has none")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = T.init_params(args.seed, cfg, device=dev)
    srv = Server(params, cfg, n_slots=args.slots, max_len=args.max_len)
    _warm_up(srv, cfg.vocab)

    doc = {"arch": cfg.name, "device": str(dev), "sla_ms": args.sla_ms}
    if args.autotune or args.rate > 0:
        from repro_torch.compiler.serve_tune import (LiveServeHost,
                                                     ServeModel, ServeSLA,
                                                     TraceConfig,
                                                     tune_while_serving)
        trace = TraceConfig(
            n_requests=args.requests, rate_per_s=args.rate,
            prompt_len=(4, max(args.max_len // 4, 5)),
            max_new=(2, args.max_new), seed=args.seed)
        host = LiveServeHost(
            srv, trace, sla=ServeSLA(target_s=args.sla_ms / 1e3),
            model=ServeModel(arch=args.arch), vocab=cfg.vocab,
            seed=args.seed)
        if args.autotune:
            rep = tune_while_serving(
                host, budget=args.budget, records=args.records,
                monitor=args.monitor, seed=args.seed,
                offline_compare=False, device=dev)
            doc["autotune"] = {
                "budget": rep.budget,
                "online": rep.online,
                "measurements": rep.serve["measurements"],
                "preempted": rep.serve["preempted"],
            }
        else:
            host.finish_serving()
        summary = host.summary()
        done = host.done
        doc.update({
            "requests": summary["served"],
            "generated_tokens": int(sum(len(r.output) for r in done)),
            "wall_s": round(summary["sim_time_s"], 3),
            "tokens_per_sec": round(summary["tokens_per_sec"] or 0.0, 1),
            "violation_pct": round(summary["violation_pct"] or 0.0, 3),
            "rejected": summary["rejected"],
            "abandoned": summary["abandoned"],
        })
        doc.update(_latency_stats(done))
    else:
        rng = np.random.default_rng(args.seed)
        t0 = time.perf_counter()
        for i in range(args.requests):
            srv.submit(Request(
                uid=i,
                prompt=rng.integers(
                    0, cfg.vocab,
                    size=int(rng.integers(4, 24))).astype(np.int32),
                max_new_tokens=args.max_new))
        done = srv.run_until_drained()
        dt = time.perf_counter() - t0
        toks = sum(len(r.output) for r in done)
        doc.update({"requests": len(done), "generated_tokens": toks,
                    "wall_s": round(dt, 3),
                    "tokens_per_sec": round(toks / dt, 1),
                    "rejected": len(srv.rejected),
                    "abandoned": len(srv.abandoned)})
        doc.update(_latency_stats(done))
        if done:
            lats = np.asarray([r.latency_s for r in done])
            doc["violation_pct"] = round(float(
                100.0 * (lats > args.sla_ms / 1e3).mean()), 3)

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
