"""Tune a configuration once with the program's ``Session`` and write the
tuning record its deploy cells run.

    python3 dcoc_bench/make_tuning.py --config vgg-16-gap --batch 64

(on the card; ``--device cpu`` for a rehearsal) writes
``dcoc_bench/configs/<config>.tuned-b<batch>.json``: each unique conv
task's layers and tuned knobs (ARCO, ``TunerConfig.fast()``, 48
measurements a task, seed 0), with the session's seconds and the card it
ran on.  A deploy cell deploys this record, as a
user deploys a tuning; it does not tune again in every set-up.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
BUDGET = 48   # measurements a task
SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.task import conv_tasks
    from repro_torch.core.tuner import TunerConfig
    with open(os.path.join(ROOT, "dcoc_bench", "configs",
                           args.config + ".json")) as f:
        model = json.load(f)["model"]
    layers = {t.name: list(t.layer_names)
              for t in conv_tasks(model, batch=args.batch)}
    t0 = time.perf_counter()
    rep = Session(TuningTask.conv_tasks(model, batch=args.batch),
                  tuner=TunerConfig.fast(), budget=BUDGET, seed=SEED,
                  device=args.device).run()
    if args.device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = os.path.join(ROOT, "dcoc_bench", "configs",
                       f"{args.config}.tuned-b{args.batch}.json")
    record = {
        "config": args.config, "batch": args.batch, "algo": "arco",
        "tuner": "fast", "budget": BUDGET, "seed": SEED,
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else args.device),
        "made_by": "python3 dcoc_bench/make_tuning.py --config "
                   f"{args.config} --batch {args.batch}",
        "session_s": seconds,
        "network_latency_s": rep.network_latency(),
        "tasks": [{"task": r.task, "layers": layers[r.task],
                   "multiplicity": r.multiplicity,
                   "knobs": r.best_settings,
                   "best_latency_s": r.best_latency} for r in rep]}
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({"out": os.path.relpath(out, ROOT),
                      "session_s": seconds,
                      "network_latency_s": record["network_latency_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
