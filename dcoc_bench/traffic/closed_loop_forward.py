"""Traffic kind ``closed_loop_forward``: a tuned CNN deployed in the
configured dtype, one client sending its next request when the last one
has returned.

A request is one batch of ``batch`` images from a pool of ``pool``
distinct pinned host batches: copied to the card, run through the
program's ``CNN.forward(x, configs)`` (every conv as im2col and the
port's GEMM at the recorded tuning's geometry), its logits copied back to
the host.  The pool is visited in a seeded order, so every seed sends the
same work.

Set-up builds the GEMM's library only (``gemm.build()``), makes the
weights on the card from the seed in one call, the pool from the seed,
maps each conv's recorded knobs to its ``GemmConfig``, and sends
``warmup_requests``.  The window then times every request on the host
clock until ``--seconds`` have passed, and the host time each forward's
call takes to return (its dispatch).  ``--trace 1`` profiles
``traced_requests`` more after it, for the device's numbers.

The check keeps ``checked_requests`` of the window's requests, a uniform
sample drawn from the seed, and runs the plain float32 reference forward
on their inputs with the same weights: ``logit_gap`` is the largest, over
their images, of max |logit - reference| / max |reference|;
``launch_gap`` how far the GEMM's launches in the window are from one
per conv per request (exact).
"""
from __future__ import annotations

import math
import random
import time

from dcoc_bench import devtrace
from dcoc_bench.reference import cnn as ref_cnn
from dcoc_bench.reference.networks import conv_layers, head_dims


def make_weights(cfg: dict, seed: int, device: str, dtype) -> dict:
    """Conv weights (HWIO, He-normal), conv biases, the head's weight and
    bias, drawn in one call on ``device`` from ``seed`` and cast to
    ``dtype``; each a view of one buffer."""
    import torch
    layers = conv_layers(cfg)
    feats, classes = head_dims(cfg)
    shapes = ([(c.k, c.k, c.ci, c.co) for c in layers]
              + [(c.co,) for c in layers] + [(feats, classes), (classes,)])
    stds = ([math.sqrt(2.0 / (c.k * c.k * c.ci)) for c in layers]
            + [cfg["assumed"]["bias_std"]] * len(layers)
            + [math.sqrt(1.0 / feats), 0.0])
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for part, std in zip(flat.split(sizes), stds):
        part.mul_(std)
    parts = [p.view(s) for p, s in zip(flat.to(dtype).split(sizes), shapes)]
    n = len(layers)
    return {"conv_w": parts[:n], "conv_b": parts[n:2 * n],
            "fc_w": parts[2 * n], "fc_b": parts[2 * n + 1]}


def gemm_configs(cfg: dict, batch: int, program_layers) -> list:
    """Each conv's ``GemmConfig``, in the program's conv order, from the
    configuration's tuning record at ``batch``."""
    from dcoc_bench.harness import ROOT, load_json
    from repro_torch.kernels.gemm import gemm_config_from_knobs
    record = load_json(ROOT, cfg["tuned"][str(batch)])
    knobs = {layer: t["knobs"] for t in record["tasks"]
             for layer in t["layers"]}
    sizes = {c.name: c for c in conv_layers(cfg)}
    out = []
    for name in program_layers:
        k, c = knobs[name], sizes[name]
        out.append(gemm_config_from_knobs(
            tile_m=k["tile_b"] * k["tile_h"] * k["tile_w"],
            tile_n=k["tile_co"], tile_k=k["tile_ci"] * c.k * c.k,
            h_threading=k["h_threading"], oc_threading=k["oc_threading"]))
    return out


def setup(run) -> None:
    import torch
    from repro_torch.kernels import gemm as G
    from repro_torch.models import cnn
    from repro_torch.models.specs import conv_specs
    cfg, mix, dev = run.config, run.mix, run.device
    dtype = getattr(torch, cfg["dtype"])
    if dev == "cuda":
        G.build()
    w = make_weights(cfg, run.seed, dev, dtype)
    net = cnn.CNN(cfg["model"], w["conv_w"], w["conv_b"], w["fc_w"],
                  w["fc_b"]).requires_grad_(False)
    configs = gemm_configs(cfg, mix["batch"],
                           [s.name for s in conv_specs(cfg["model"])])
    size = mix.get("image_size", cfg["image_size"])
    gen = torch.Generator(device=dev).manual_seed(run.seed + 1)
    pool = torch.randn((mix["pool"], mix["batch"], size, size,
                        cfg["in_channels"]), generator=gen, device=dev,
                       dtype=dtype)
    host = torch.empty(pool.shape, dtype=dtype, pin_memory=dev == "cuda")
    host.copy_(pool)
    del pool
    run.state.update(weights=w, net=net, configs=configs, pool=host,
                     forward=lambda x: net(x, configs),
                     order=random.Random(run.seed).sample(
                         range(mix["pool"]), mix["pool"]))
    with torch.no_grad():
        for i in range(mix["warmup_requests"]):
            _request(run, i)


def _request(run, i: int):
    """Request ``i``: its pool index, its logits on the host, and the
    host seconds the forward's call took to return (its dispatch)."""
    j = run.state["order"][i % len(run.state["order"])]
    x = run.state["pool"][j].to(run.device, non_blocking=True)
    t0 = time.perf_counter()
    y = run.state["forward"](x)
    enqueue = time.perf_counter() - t0
    return j, y.to("cpu"), enqueue


def window(run) -> None:
    import torch
    from repro_torch.kernels import gemm as G
    k = run.mix["checked_requests"]
    rng = random.Random(run.seed)
    kept, lat, enqueue = [], [], []
    failed = 0
    with torch.no_grad():
        G.gemm.launches = 0
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            j, out, enq = _request(run, len(lat))
            t1 = time.perf_counter()
            n = len(lat)
            lat.append(t1 - t0)
            enqueue.append(enq)
            failed += not bool(torch.isfinite(out).all())
            if n < k:                       # a uniform sample of k
                kept.append((j, out))
            elif rng.randrange(n + 1) < k:
                kept[rng.randrange(k)] = (j, out)
            if t1 - t_start >= run.seconds:
                break
        launches = G.gemm.launches
    run.obs.update(window_s=t1 - t_start, latencies=lat, enqueue_s=enqueue,
                   images=len(lat) * run.mix["batch"],
                   detail={"requests": len(lat), "window_s": t1 - t_start,
                           "first_ms": 1e3 * lat[0],
                           "mean_ms": 1e3 * sum(lat) / len(lat),
                           "max_ms": 1e3 * max(lat)})
    run.state.update(kept=kept, launches=launches)
    run.attempted, run.failed = len(lat), failed


def trace(run) -> None:
    import torch
    from torch.profiler import record_function

    def go():
        with torch.no_grad():
            for i in range(run.mix["traced_requests"]):
                j = run.state["order"][i % len(run.state["order"])]
                with record_function("request"):
                    with record_function("h2d"):
                        x = run.state["pool"][j].to(run.device,
                                                    non_blocking=True)
                    with record_function("forward"):
                        y = run.state["forward"](x)
                    with record_function("d2h"):
                        y.to("cpu")

    run.devtrace = devtrace.profiled(go, "request", ("h2d", "forward",
                                                     "d2h"))
    run.obs["traced_requests"] = run.mix["traced_requests"]


def logit_gap(run, forward_ref) -> float:
    """The largest, over the sampled requests' images, of max |logit -
    reference| / max |reference|; the reference's logits come from
    ``forward_ref(pool index)``."""
    import torch
    worst, refs = 0.0, {}
    for j, out in run.state["kept"]:
        if j not in refs:
            refs[j] = forward_ref(j).float().cpu()
        ref = refs[j]
        gap = ((out.float() - ref).abs().amax(dim=1)
               / ref.abs().amax(dim=1)).max()
        worst = float("nan") if torch.isnan(gap) else max(worst, float(gap))
    return worst


def reference_forward(run, quant=None):
    """The plain forward on the pool's batch ``j``, with the weights the
    program ran."""
    w = run.state["weights"]
    return lambda j: ref_cnn.forward(
        run.config, w["conv_w"], w["conv_b"], w["fc_w"], w["fc_b"],
        run.state["pool"][j].to(run.device), quant=quant)


def check(run) -> None:
    import torch
    for key in ("net", "forward", "configs"):
        run.state.pop(key, None)
    if run.device == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        gap = logit_gap(run, reference_forward(run))
    # the GEMM counts its launches on the card; on the CPU it runs its
    # plain version, which launches nothing
    want = len(conv_layers(run.config)) * run.attempted
    run.checks = {"logit_gap": gap,
                  "launch_gap": abs(run.state["launches"] - want)
                  if run.device == "cuda" else 0}
