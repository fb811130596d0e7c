"""Traffic kind ``serve_decode_kda``: a Kimi Linear LM (the configuration's
``config.json`` keys: KDA and NoPE MLA layers, the MoE of one chip's
expert share) served by the program's continuous-batching ``Server``
with every slot live, timed a decode step at a time.

The run is ``serve_decode``'s, whose functions it shares: set-up builds
the flash, RMSNorm, MLA decode and KDA decode kernels, the model from the
seed on the card (``init_params``: bfloat16; the router, the correction
bias, KDA's ``A_log`` and ``dt_bias`` fp32) and a ``Server(slots,
max_len)``; ``slots`` prompts of [``prompt_min``, ``prompt_max``] seeded
tokens, each asking for ``max_len`` less its prompt's tokens, admitted by
the first step (one prefill each: KDA's chunked form, the flash kernel
for MLA, the grouped MoE); the checked steps, untimed; ``warmup_steps``;
then the window times every ``Server.step()`` (``fwd_p95_ms``) and the
host time to ``decode_step``'s return (``dispatch_ms``).  ``--trace 1``
profiles ``traced_steps`` more steps under a tracer whose ``kda``,
``mla``, ``moe`` and ``mlp`` spans are profiler ranges, attributing each
kernel to its span by the profiler's correlation ids, and keeps the
step's counters (``moe.experts_touched``, ``moe.pairs_elsewhere``).

The check, as ``serve_decode``'s: ``checked_slots`` requests, each with
``checked_steps`` of the first ``check_span`` decode steps, their logits
kept and the program's expert sets logged; after the window the plain
float32 reference (``reference/kimi_linear.py``: KDA by its recurrence a
token at a time, the expert share's held experts replaying the
program's sets) runs each request's tokens up to its last sampled step:

* ``logit_gap``: the largest, over the sampled (request, step), of
  max |logit - reference| / max |reference|;
* ``route_gap``: the share of (token, MoE layer) pairs whose program set
  differs from the reference's own choice there;
* ``drop_gap``: held token-expert pairs the dispatch dropped over the
  checked steps (``moe.tokens_dropped``; exactly 0).

:data:`FAULTS` are the faults the limits were set against, planted in
the program by :func:`planted`; :func:`control_checks` reads the
control's numbers.
"""
from __future__ import annotations

import contextlib

from dcoc_bench import devtrace, roofline_kda
from dcoc_bench.traffic import serve_decode as SD

SPANS = ("kda", "mla", "moe", "mlp")
KERNELS = ("flash_attention", "rmsnorm", "mla_decode", "kda_decode")
# what the program implements of a kimi_linear config.json
REQUIRED = {"model_type": "kimi_linear",
            "moe_router_activation_func": "sigmoid", "num_expert_group": 1,
            "topk_group": 1, "use_grouped_topk": True,
            "moe_renormalize": True, "q_lora_rank": None,
            "hidden_act": "silu", "moe_layer_freq": 1,
            "mla_use_nope": True, "rope_scaling": None,
            "tie_word_embeddings": False, "num_nextn_predict_layers": 0}


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
    la, dep = cfg["linear_attn_config"], cfg["deployment"]
    n = cfg["num_hidden_layers"]
    full, kda = set(la["full_attn_layers"]), set(la["kda_layers"])
    if full & kda or full | kda != set(range(1, n + 1)):
        raise ValueError("full_attn_layers and kda_layers must split the "
                         f"{n} layers")
    dtype = getattr(torch, cfg["dtype"])
    return MLAConfig(
        name=cfg["arch"], family="hybrid", n_layers=n,
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        pattern=(("kda", "moe"),),      # the FFNs; the mixers listed
        layer_mixers=tuple(roofline_kda.mixers(cfg)),
        rope_theta=float(cfg["rope_theta"]),
        n_experts=dep["num_experts_published"],
        moe_top_k=cfg["num_experts_per_token"], moe_impl="grouped",
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_shared_experts=cfg["num_shared_experts"],
        first_k_dense=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"], moe_scoring="sigmoid",
        routed_scaling=float(cfg["routed_scaling_factor"]),
        route_bias_std=float(cfg["assumed"]["correction_bias_std"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]), dtype=dtype,
        param_dtype=dtype, mla_nope=cfg["mla_use_nope"],
        kda_heads=la["num_heads"], kda_head_dim=la["head_dim"],
        kda_conv=la["short_conv_kernel_size"],
        kda_gate_rank=cfg["assumed"]["kda_gate_rank"],
        n_experts_held=cfg["num_experts"],
        experts_held_from=dep["experts_held_from"])


def setup(run) -> None:
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.train.server import Request, Server
    cfg, mix = arch_config(run.config), run.mix
    if run.device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(KERNELS)
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
                     picks=picks, n_moe=n_moe, captured={}, finished=0,
                     states={})
    with torch.no_grad(), _keeping_states(run):
        SD._checked_steps(run, max(max(js) for js in picks.values()))
        log = run.state["step_routes"][0]
        run.state["prompt_routes"] = {
            r: log[r * n_moe:(r + 1) * n_moe] for r in checked}
        run.state["step_routes"][0] = log[n * n_moe:]
        for _ in range(mix["warmup_steps"]):
            SD._step(run)


@contextlib.contextmanager
def _keeping_states(run):
    """The run's ``Server.step`` keeping every KDA layer's state of a
    checked request's slot, on the host, after each of its sampled steps
    and the step before it (``run.state["states"][(request, step)]``:
    (KDA layers, H, d, d) float32)."""
    import torch
    s = run.state
    server = s["server"]
    real = server.step
    kda = [i for i, (m, _) in enumerate(s["cfg"].layer_kinds())
           if m == "kda"]
    steps = []

    def step():
        out = real()
        j = len(steps)
        steps.append(j)
        if j == 0:
            s["state_slot"] = {req.uid: slot
                               for slot, req in server.active.items()}
        for r, js in s["picks"].items():
            if j in js or j + 1 in js:
                slot = s["state_slot"][r]
                s["states"][(r, j)] = torch.stack(
                    [server.cache["layers"][i]["S"][slot] for i in kda]
                ).cpu()
        return out

    server.step = step
    try:
        yield
    finally:
        del server.step


def update_gap(before, after, device=None) -> float:
    """The largest, over the heads of KDA states ``before`` and ``after``
    (..., d, d) one decode step apart, of the share of ``after`` that no
    delta-rule step explains: the least over a, k, w in R^d of ||after -
    Diag(a) before - k w^T||_F / ||after||_F (a step is Diag(exp g) S +
    beta k^ (v - u)^T: a row scaling and a rank-one term).

    In float64 on ``device``.  Each row of ``after`` lies in the span of
    its row of ``before`` and w, so w starts as the top eigenvector of the
    sum of those spans' projectors, each weighed by the share of its row
    the step changed (on the host, where LAPACK takes what cuSOLVER may
    not converge on); 200 passes of alternating least squares, over-
    relaxed, then fit (a_i, k_i) of each row given w and w given them.
    An fp32 step reads ~5e-8; a state rounded to bf16 6e-4 or more."""
    import torch
    a_s = after.to(device, torch.float64).flatten(0, -3)
    b_s = before.to(device, torch.float64).flatten(0, -3)
    bb, ab = (b_s * b_s).sum(-1), (a_s * b_s).sum(-1)
    unit = lambda t: t / t.norm(dim=-1, keepdim=True).clamp_min(1e-300)
    # each row's span weighed by the share of it the step changed: a row
    # changed at the rounding's level (or not at all) says nothing of w
    moved = a_s - (ab / bb.clamp_min(1e-300))[..., None] * b_s
    weight = moved.norm(dim=-1, keepdim=True) \
        / a_s.norm(dim=-1, keepdim=True).clamp_min(1e-300)
    e1, e2 = weight * unit(b_s), weight * unit(moved)
    spans = e1.transpose(-1, -2) @ e1 + e2.transpose(-1, -2) @ e2
    w = torch.linalg.eigh(spans.cpu()).eigenvectors[..., -1].to(a_s.device)
    bb = bb + 1e-30 * bb.mean(-1, keepdim=True) + 1e-300   # a zero row: a 0
    for n in range(201):
        bw, aw = (b_s @ w[..., None])[..., 0], (a_s @ w[..., None])[..., 0]
        ww = (w * w).sum(-1, keepdim=True)
        det = bb * ww - bw * bw
        a, k = (ab * ww - aw * bw) / det, (bb * aw - bw * ab) / det
        if n == 200:
            break
        fit = (k[..., None] * (a_s - a[..., None] * b_s)).sum(-2) \
            / (k * k).sum(-1, keepdim=True).clamp_min(1e-300)
        w = w + (1.5 if n > 2 else 1.0) * (fit - w)
    res = a_s - a[..., None] * b_s - k[..., :, None] * w[..., None, :]
    return float((res.norm(dim=(-2, -1)) / a_s.norm(dim=(-2, -1))).max())


window = SD.window


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
        span_device_s=SD.span_device_seconds(
            prof.profiler.kineto_results.events(), SPANS),
        experts_touched=counters.get("moe.experts_touched"),
        pairs_elsewhere=counters.get("moe.pairs_elsewhere"))
    per_step = {k: v / len(contexts) for k, v in counters.items()}
    run.obs.setdefault("detail", {})["traced_counters_a_step"] = per_step


def check(run, quant=None) -> None:
    import torch
    from dcoc_bench.reference import kimi_linear as ref
    s = run.state
    s["server"] = None                      # the cache, the last logits
    if run.device == "cuda":
        torch.cuda.empty_cache()
    seqs, at, routes, keys = SD.reference_inputs(run)
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
                  "drop_gap": s["dropped"],
                  "update_gap": _largest(
                      update_gap(s["states"][(r, j - 1)], s["states"][(r, j)],
                                 run.device)
                      for r, js in s["picks"].items() for j in js)}


def _largest(values) -> float:
    """The largest of ``values``, NaN if any is."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def control_checks(run, params, quant: str) -> dict:
    """The compared numbers of the control: the reference computed with
    every product's operands rounded to ``quant`` (``"bf16"``, ``"fp8"``)
    in the program's place, on the same requests and tokens, choosing its
    own experts, against the float32 reference replaying them.  For
    setting the limits (PERF.md section 2); the runs never call it."""
    import torch
    from dcoc_bench.reference import kimi_linear as ref
    seqs, at, _, _ = SD.reference_inputs(run)
    pairs = [[p + i for p in ps for i in (-1, 0)] for ps in at]
    with torch.no_grad():
        low = ref.forward(run.config, params, seqs, at, quant=quant,
                          device=run.device, states_at=pairs)
        want = ref.forward(run.config, params, seqs, at,
                           routes=low["own_routes"], device=run.device)
    gap = max(float((got - w).abs().max() / w.abs().max())
              for gs, ws in zip(low["logits"], want["logits"])
              for got, w in zip(gs, ws))
    steps = _largest(update_gap(torch.stack([t[i] for t in layers]),
                                torch.stack([t[i + 1] for t in layers]),
                                run.device)
                for layers in low["states"]
                for i in range(0, len(layers[0]), 2))
    return {"logit_gap": gap,
            "route_gap": want["route_mismatch"] / want["route_tokens"],
            "update_gap": steps}


# the faults the limits were set against: (module, function, the fault
# made from the real function)
def _delta_dropped(real):
    """The decode step's state update without the delta correction: S =
    Diag(exp g) S + beta k^ v^T (plain torch, on the card too)."""
    def step(q, k, v, g, beta, state, scale, use_kernel=True):
        import torch
        from repro_torch.kernels import kda_decode as KK
        qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + KK.L2_EPS)
        kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + KK.L2_EPS)
        state.mul_(torch.exp(g)[..., None])
        state.add_(kn[..., :, None] * (beta[..., None] * v)[..., None, :])
        return (qn[..., None, :] @ state).squeeze(-2) * scale
    step.launches = 0
    return step


def _decay_ignored(real):
    import torch

    def gates(h, p, cfg):
        g, beta = real(h, p, cfg)
        return torch.zeros_like(g), beta
    return gates


def _tails_dropped(real):
    import torch

    def block(x, p, cfg, use_kernel=True):
        x, entry = real(x, p, cfg, use_kernel=use_kernel)
        return x, {k: t if k == "S" else torch.zeros_like(t)
                   for k, t in entry.items()}
    return block


def _state_bf16(real):
    """Each KDA layer's state rounded to bf16 after every decode step."""
    import torch

    def decode(x, p, cfg, entry, use_kernel=True):
        out = real(x, p, cfg, entry, use_kernel=use_kernel)
        entry["S"].copy_(entry["S"].to(torch.bfloat16))
        return out
    return decode


def _rope_in_nope(real):
    return lambda cfg: real(cfg).with_(mla_nope=False)


def _wrong_experts(real):
    def experts(h, w, idx, p, first=0):
        return real(h, w, idx, p, first + p["w_gate"].shape[0])
    return experts


FAULTS = {
    "delta_dropped": ("repro_torch.kernels.kda_decode", "kda_recurrence",
                      _delta_dropped),
    "decay_ignored": ("repro_torch.models.kda", "gates", _decay_ignored),
    "tails_dropped": ("repro_torch.models.kda", "kda_block", _tails_dropped),
    "state_bf16": ("repro_torch.models.kda", "kda_decode", _state_bf16),
    "rope_in_nope": (None, "arch_config", _rope_in_nope),
    "wrong_experts": ("repro_torch.models.moe", "experts_grouped",
                      _wrong_experts),
}


@contextlib.contextmanager
def planted(fault: str):
    """The program with one of :data:`FAULTS` in it (a module of None:
    this one's)."""
    import importlib
    module, name, make = FAULTS[fault]
    owner = vars(importlib.import_module(module)) if module else globals()
    real = owner[name]
    owner[name] = make(real)
    try:
        yield
    finally:
        owner[name] = real
