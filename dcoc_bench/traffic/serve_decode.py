"""Traffic kind ``serve_decode``: a DeepSeek-V3-block LM (the
configuration's ``config.json`` keys) served by the program's
continuous-batching ``Server`` with every slot live, timed a decode step
at a time.

Set-up builds the flash, RMSNorm and MLA decode kernels, the model from the seed on
the card (``init_params``: bfloat16, the router and the correction bias
fp32), and a ``Server(slots, max_len)``.  It submits ``slots`` requests
whose prompts are drawn from the seed (lengths uniform in
[``prompt_min``, ``prompt_max``], ids uniform over the vocabulary), each
asking for ``max_len`` less its prompt's tokens, so that none finishes in
the window; the first ``Server.step()`` admits them all (one prefill
each, the flash kernel and the grouped MoE) and decodes once.  The
checked steps follow, untimed, on the same server at the same load (see
below), then ``warmup_steps`` more steps as the window runs them.

The window times every ``Server.step()``: one greedy decode of all the
slots, from the call to the tokens on the host (``run.obs["latencies"]``,
so ``fwd_p95_ms`` is the 95th percentile of the gap between a slot's
output tokens), until ``--seconds`` have passed; and the host time from
the call to ``decode_step``'s return, before the server copies the
tokens back (``run.obs["enqueue_s"]``, read by ``dispatch_ms``).  Its
steps carry no logging.  ``--trace 1`` profiles ``traced_steps`` more
steps under a tracer whose ``mla``/``moe``/``mlp`` spans are profiler
ranges, and attributes each kernel to the span its launch was made in
through the profiler's correlation ids.

The check: ``checked_slots`` requests drawn from the seed, each with
``checked_steps`` of the first ``check_span`` decode steps after
admission, all run before the window.  Until the last sampled step the
program's expert sets of every token, prompt and outputs, are kept as
the router makes them (``moe.route_log``), the sampled requests' logits
are copied to the host as their step returns, and the steps run under a
tracer of their own whose ``moe.tokens_dropped`` counts the pairs the
dispatch left out.  After the window the program's cache and server are
freed; the plain float32 reference (``reference/deepseek_v3.py``) runs
each request's prompt and outputs up to its last sampled step with the
program's weights, replaying the program's expert sets:

* ``logit_gap``: the largest, over the sampled (request, step), of
  max |logit - reference| / max |reference|;
* ``route_gap``: the share of (token, MoE layer) pairs whose program set
  differs from the reference's own choice there;
* ``drop_gap``: token-expert pairs the dispatch dropped over the checked
  steps (``moe.tokens_dropped``; exactly 0).

:data:`FAULTS` are the faults the limits were set against, planted in
the program by :func:`planted`; :func:`control_checks` reads the
control's numbers.
"""
from __future__ import annotations

import bisect
import contextlib
import time

from dcoc_bench import devtrace

SPANS = ("mla", "moe", "mlp")
# what the program implements of a deepseek_v3 config.json
REQUIRED = {"model_type": "deepseek_v3", "scoring_func": "sigmoid",
            "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
            "norm_topk_prob": True, "q_lora_rank": None,
            "hidden_act": "silu", "moe_layer_freq": 1,
            "attention_bias": False, "tie_word_embeddings": False,
            "num_nextn_predict_layers": 0}


def arch_config(cfg: dict):
    """The program's ``MLAConfig`` of a configuration file."""
    import torch
    from repro_torch.models.transformer import MLAConfig
    for key, want in REQUIRED.items():
        if cfg.get(key) != want:
            raise ValueError(f"{key} {cfg.get(key)!r}: the program runs "
                             f"{want!r}")
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("MLA expands one latent to every head's keys")
    dtype = getattr(torch, cfg["dtype"])
    return MLAConfig(
        name=cfg["arch"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        pattern=(("mla", "moe"),), rope_theta=float(cfg["rope_theta"]),
        n_experts=cfg["n_routed_experts"],
        moe_top_k=cfg["num_experts_per_tok"], moe_impl="grouped",
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_shared_experts=cfg["n_shared_experts"],
        first_k_dense=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        moe_scoring=cfg["scoring_func"],
        routed_scaling=float(cfg["routed_scaling_factor"]),
        route_bias_std=float(cfg["assumed"]["correction_bias_std"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]), dtype=dtype,
        param_dtype=dtype)


def setup(run) -> None:
    import numpy as np
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.train.server import Request, Server
    cfg, mix = arch_config(run.config), run.mix
    if run.device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(("flash_attention", "rmsnorm", "mla_decode"))
    params = T.init_params(run.seed, cfg, device=run.device)
    server = Server(params, cfg, n_slots=mix["slots"],
                    max_len=mix["max_len"])
    rng = np.random.default_rng(run.seed)
    n = mix["slots"]
    lengths = rng.integers(mix["prompt_min"], mix["prompt_max"] + 1, size=n)
    prompts = [rng.integers(0, cfg.vocab, size=int(k)).astype(np.int32)
               for k in lengths]
    checked = sorted(rng.choice(n, mix["checked_slots"], replace=False)
                     .tolist())
    # decode step j of a request's outputs (0: the one admission makes)
    picks = {r: sorted((1 + rng.choice(
        mix["check_span"], mix["checked_steps"], replace=False)).tolist())
        for r in checked}
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    reqs = [server.submit(Request(uid=i, prompt=p,
                                  max_new_tokens=mix["max_len"] - len(p)))
            for i, p in enumerate(prompts)]
    run.state.update(cfg=cfg, params=params, server=server, requests=reqs,
                     picks=picks, n_moe=n_moe, captured={}, finished=0)
    with torch.no_grad():
        _checked_steps(run, max(max(js) for js in picks.values()))
        log = run.state["step_routes"][0]
        run.state["prompt_routes"] = {
            r: log[r * n_moe:(r + 1) * n_moe] for r in checked}
        run.state["step_routes"][0] = log[n * n_moe:]
        for _ in range(mix["warmup_steps"]):
            _step(run)


def _step(run) -> tuple:
    """One ``Server.step()``; the host clock at its call and return."""
    s = run.state
    server = s["server"]
    if not server.active and not server.queue:
        raise RuntimeError("every request finished: the cell's traffic "
                           "asks for more tokens than max_len holds")
    t0 = time.perf_counter()
    s["finished"] += len(server.step())
    return t0, time.perf_counter()


def _checked_steps(run, last: int) -> None:
    """Steps 0 (admission: every prefill, one decode) to ``last``, the
    last sampled step: each step's expert sets kept
    (``run.state["step_routes"]``), the sampled requests' logits copied
    to the host, the dispatch's dropped pairs counted
    (``run.state["dropped"]``)."""
    from repro_torch import obs
    from repro_torch.models import moe as MOE
    s = run.state
    server = s["server"]
    tracer = obs.Tracer(name="check")
    s["step_routes"] = []
    MOE.route_log = []
    try:
        with obs.use(tracer):
            for j in range(last + 1):
                _step(run)
                s["step_routes"].append(list(MOE.route_log))
                MOE.route_log.clear()
                if j == 0:
                    s["slot"] = {req.uid: slot
                                 for slot, req in server.active.items()}
                for r, js in s["picks"].items():
                    if j in js:
                        s["captured"][(r, j)] = server.last_logits[
                            s["slot"][r]].float().cpu()
    finally:
        MOE.route_log = None
    counters = tracer.metrics.snapshot()["counters"]
    s["dropped"] = float(counters.get("moe.tokens_dropped", float("nan")))


@contextlib.contextmanager
def _enqueue_marks(marks: list):
    """``transformer.decode_step``, which ``Server.step`` calls, noting
    the host clock in ``marks`` as it returns."""
    from repro_torch.models import transformer as T
    real = T.decode_step

    def noted(*args, **kwargs):
        out = real(*args, **kwargs)
        marks.append(time.perf_counter())
        return out

    T.decode_step = noted
    try:
        yield
    finally:
        T.decode_step = real


def window(run) -> None:
    import torch
    s = run.state
    lat, enqueue, marks, tokens = [], [], [], 0
    with torch.no_grad(), _enqueue_marks(marks):
        t_start = time.perf_counter()
        while True:
            live = len(s["server"].active)
            t0, t1 = _step(run)
            lat.append(t1 - t0)
            enqueue.append(marks[-1] - t0)
            tokens += live
            if t1 - t_start >= run.seconds:
                break
        window_s = time.perf_counter() - t_start
    pos = s["server"].cache["pos"]
    run.obs.update(latencies=lat, enqueue_s=enqueue, window_s=window_s,
                   tokens=tokens,
                   detail={"steps": len(lat), "window_s": window_s,
                           "tokens_per_s": tokens / window_s,
                           "mean_ms": 1e3 * sum(lat) / len(lat),
                           "max_ms": 1e3 * max(lat),
                           "finished": s["finished"],
                           "context_min": int(pos.min()),
                           "context_max": int(pos.max())})
    run.attempted = tokens


def span_device_seconds(events, names=SPANS) -> dict:
    """Device seconds of the kernels launched inside each named profiler
    range, from the profiler's raw (Kineto) events: a kernel's
    correlation id leads to the host call that launched it, whose start
    lies in the range."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = {n: [] for n in names}
    launched = {}
    kernels = []
    for e in events:
        if e.device_type() == cpu:
            if e.name() in ranges:
                ranges[e.name()].append((e.start_ns(), e.end_ns()))
            launched[e.correlation_id()] = e.start_ns()
        elif e.device_type() == cuda and e.name() not in ranges \
                and not e.is_user_annotation():
            kernels.append((e.linked_correlation_id(), e.correlation_id(),
                            e.duration_ns()))
    spans = sorted((s0, s1, n) for n, rs in ranges.items() for s0, s1 in rs)
    starts = [s0 for s0, _, _ in spans]
    out = {n: 0.0 for n in names}
    for linked, corr, dur in kernels:
        t = launched.get(linked, launched.get(corr))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            out[spans[i][2]] += dur / 1e9
    return out


def trace(run) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from dcoc_bench import spans
    from repro_torch import obs
    s = run.state
    tracer = spans.profiled_tracer()
    contexts = []

    def go():
        with obs.use(tracer), torch.no_grad():
            for _ in range(run.mix["traced_steps"]):
                contexts.append((s["server"].cache["pos"] + 1).tolist())
                with record_function("step"):
                    s["server"].step()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        go()
        torch.cuda.synchronize()
    run.devtrace = devtrace.reduce(prof.events(), "step", ("step",) + SPANS)
    counters = {k: float(v) for k, v in
                tracer.metrics.snapshot()["counters"].items()}
    run.obs.update(
        traced_steps=len(contexts), traced_contexts=contexts,
        span_device_s=span_device_seconds(
            prof.profiler.kineto_results.events()),
        experts_touched=counters.get("moe.experts_touched"))
    per_step = {k: v / len(contexts) for k, v in counters.items()}
    run.obs.setdefault("detail", {})["traced_counters_a_step"] = per_step


def reference_inputs(run):
    """Per checked request: its tokens up to its last sampled step, the
    positions of its sampled steps, and the program's expert sets of each
    token, per MoE layer."""
    import torch
    s = run.state
    seqs, at, routes, keys = [], [], [], []
    for r, js in sorted(s["picks"].items()):
        req, slot = s["requests"][r], s["slot"][r]
        n = len(req.prompt)
        last = max(js)
        seqs.append(torch.as_tensor(
            list(req.prompt) + req.output[:last + 1], dtype=torch.long))
        at.append([n + j for j in js])
        keys.append([(r, j) for j in js])
        routes.append([torch.cat(
            [s["prompt_routes"][r][m]]
            + [s["step_routes"][j][m][slot:slot + 1]
               for j in range(last + 1)]).cpu()
            for m in range(s["n_moe"])])
    return seqs, at, routes, keys


def check(run, quant=None) -> None:
    import torch
    from dcoc_bench.reference import deepseek_v3 as ref
    s = run.state
    s["server"] = None                      # the cache, the last logits
    if run.device == "cuda":
        torch.cuda.empty_cache()
    seqs, at, routes, keys = reference_inputs(run)
    with torch.no_grad():
        out = ref.forward(run.config, s["params"], seqs, at, routes=routes,
                          quant=quant, device=run.device)
    gap = 0.0
    failed = 0
    for rows, names in zip(out["logits"], keys):
        for want, key in zip(rows.cpu(), names):
            got = s["captured"][key]
            failed += not bool(torch.isfinite(got).all())
            g = float((got - want).abs().max() / want.abs().max())
            gap = float("nan") if g != g else max(gap, g)
    run.failed = failed
    run.checks = {"logit_gap": gap,
                  "route_gap": out["route_mismatch"] / out["route_tokens"],
                  "drop_gap": s["dropped"]}


def control_checks(run, params, quant: str) -> dict:
    """The compared numbers of the control: the reference computed with
    every product's operands rounded to ``quant`` (``"bf16"``, ``"fp8"``)
    in the program's place, on the same requests and tokens, choosing its
    own experts, against the float32 reference replaying them.  For
    setting the limits (PERF.md section 2); the runs never call it."""
    import torch
    from dcoc_bench.reference import deepseek_v3 as ref
    seqs, at, _, _ = reference_inputs(run)
    with torch.no_grad():
        low = ref.forward(run.config, params, seqs, at, quant=quant,
                          device=run.device)
        want = ref.forward(run.config, params, seqs, at,
                           routes=low["own_routes"], device=run.device)
    gap = max(float((got - w).abs().max() / w.abs().max())
              for gs, ws in zip(low["logits"], want["logits"])
              for got, w in zip(gs, ws))
    return {"logit_gap": gap,
            "route_gap": want["route_mismatch"] / want["route_tokens"]}


# the faults the limits were set against: (module, function, the fault
# made from the real function)
def _bias_ignored(real):
    import torch
    return lambda h, p, cfg: real(h, dict(p, bias=torch.zeros_like(
        p["bias"])), cfg)


def _no_scaling(real):
    def route(h, p, cfg):
        w, idx = real(h, p, cfg)
        return w / cfg.routed_scaling, idx
    return route


def _shared_skipped(real):
    return lambda h, p: real(h, p) * 0


def _decode_not_absorbed(real):
    def weights(p, cfg):
        w_uk, w_uv = real(p, cfg)       # the halves of W_kvb swapped
        return w_uv.transpose(1, 2), w_uk.transpose(1, 2)
    return weights


FAULTS = {
    "bias_ignored": ("repro_torch.models.moe", "route_sigmoid",
                     _bias_ignored),
    "no_scaling": ("repro_torch.models.moe", "route_sigmoid", _no_scaling),
    "shared_skipped": ("repro_torch.models.moe", "shared_expert",
                       _shared_skipped),
    "decode_not_absorbed": ("repro_torch.models.mla", "absorbed_weights",
                            _decode_not_absorbed),
}


@contextlib.contextmanager
def planted(fault: str):
    """The program with one of :data:`FAULTS` in it."""
    import importlib
    module, name, make = FAULTS[fault]
    owner = importlib.import_module(module)
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)
