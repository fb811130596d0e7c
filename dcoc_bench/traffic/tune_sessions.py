"""Traffic kind ``tune_sessions``: whole-network tuning sessions, back to
back, as a compiler engineer runs them.

Each session is the program's ``Session(tasks, ...).run()`` over every
unique conv task of the configured network at the mix's ``batch``, with
its ``algo``, the tuner's settings of the configuration (``iteration_opt``
iterations of ``b_measure`` measurements a task, ``episodes_per_iter``
MAPPO episodes of ``mappo_n_steps`` steps in ``mappo_n_envs``
environments, a GBT of ``gbt_rounds`` trees), in process, on the card,
recording every measurement to a JSONL ``RecordLog`` under ``TMPDIR``.
The harness hands the session its GBT, built as the configuration
states, and reads the fitted forest back once the session has ended.
Session ``i`` of a run takes the seed ``seed * SEED_STRIDE + i``.
Sessions start while the window's seconds last; the last one is let
finish, so a session is counted whole.

Set-up imports the program and runs one session over the first
``warmup_tasks`` tasks at the full budget, which launches every kernel a
session does.  ``--trace 1`` also installs a span tracer over the window,
and profiles, after it, a one-task session of task ``profiled_task``.

The check recomputes, per session:

* every measured configuration's latency with the frozen analytical
  reference (float64): ``latency_gap``, the largest relative gap of a
  measured latency; ``best_gap``, how far a task's reported best lies
  from the least latency the session measured for it, and from the
  latency measured at the reported best configuration (exact);
  ``network_gap``, the relative gap of the network latency (sum of
  multiplicity x best) to the reference's; ``count_gap``, the largest
  departure of a task's measurements from the budget (:func:`count_gap`;
  exact);
* the surrogate's last refit: a plain GBT fit (``reference/gbt.py``) on
  the session's measured rows, features and targets worked out by the
  reference, which takes the program's split wherever it ties with the
  best to within rounding; ``gbt_gap``, the largest gap over those rows
  between the program's forest's prediction and the reference's, over
  the targets' standard deviation;
* for ARCO, one MAPPO episode of the session, drawn from the seed: the
  reference (``reference/ppo.py``) follows its update from the state it
  started in (the parameters and the optimizer's moments, which are the
  program's own state) on the rollout it made, whose observations and
  rewards it works out again; ``mappo_loss_gap``, the relative gap of the
  episode's last epoch's loss, and ``mappo_step_gap``, the 2-norm of the
  difference of the parameters' changes over the reference's change, over
  the elements whose first gradient in the reference is at least a
  thousandth of the median element's.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import random
import tempfile
import time

import numpy as np

from dcoc_bench import devtrace, spans
from dcoc_bench.reference import analytical, gbt as ref_gbt, ppo
from dcoc_bench.reference.networks import tasks as ref_tasks

SEED_STRIDE = 1000
SPAN_NAMES = ("session", "seed-draw", "mappo-update", "measure",
              "measure-wait", "surrogate-refit")
MAPPO_KEYS = ("gamma", "gae_lambda", "clip", "lr", "vf_coef", "ent_coef",
              "epochs")


def hyper(cfg: dict) -> dict:
    """The MAPPO update's settings as the configuration states them."""
    return {k: cfg["mappo_" + k] for k in MAPPO_KEYS + (
        "clip_norm", "b1", "b2", "eps")}


def tuner(cfg: dict):
    """The program's ``TunerConfig`` as the configuration states it."""
    from repro_torch.core import mappo
    from repro_torch.core.tuner import TunerConfig
    hp = mappo.MappoConfig(n_steps=cfg["mappo_n_steps"],
                           n_envs=cfg["mappo_n_envs"],
                           **{k: cfg["mappo_" + k] for k in MAPPO_KEYS})
    return TunerConfig(iteration_opt=cfg["iteration_opt"],
                       b_measure=cfg["b_measure"],
                       episodes_per_iter=cfg["episodes_per_iter"],
                       mappo=hp, gbt_rounds=cfg["gbt_rounds"])


def budget(cfg: dict) -> int:
    return cfg["iteration_opt"] * cfg["b_measure"]


def searched(run, wl: dict) -> int:
    """How many configurations the mix's algorithm can measure in a layer:
    AutoTVM holds the hardware knobs (the first three) and searches the
    rest; ARCO searches them all."""
    sizes = [len(c) for c in analytical.choices(wl)]
    return math.prod(sizes[3:] if run.mix["algo"] == "autotvm" else sizes)


def count_gap(run, wl: dict, rows: int, reported: int) -> float:
    """How far a task's measurements lie from what the tuner states: the
    budget, where the searched space holds twice the budget or more;
    elsewhere at most the budget and the space, and more than the seed
    batch (a search stops at a round that finds nothing new, which in a
    small space can leave a few configurations unmeasured).  The report
    has to count what the records hold."""
    space, want = searched(run, wl), budget(run.config)
    gap = abs(reported - rows)
    if space >= 2 * want:
        return max(gap, abs(rows - want))
    return max(gap, rows - min(space, want),
               run.config["b_measure"] + 1 - rows, 0)


def _tasks(run):
    from repro_torch.compiler.task import TuningTask
    tasks = TuningTask.conv_tasks(run.config["model"], batch=run.mix["batch"])
    return tasks[:run.mix.get("max_tasks", len(tasks))]


@contextlib.contextmanager
def episode_caught(pick):
    """Around a session: keeps the state before and after its ``pick``-th
    MAPPO episode (None: none), the rollout's configurations and moves,
    the surrogate it was scored with, and the loss the episode returned."""
    from repro_torch.core import mappo
    real_episode, real_rollout = mappo.train_episode, mappo.rollout
    caught, seen, box = [], [0], {}

    def rollout(nets, gen, env, forest, config0, hp):
        traj = real_rollout(nets, gen, env, forest, config0, hp)
        box.update(config0=config0, traj=traj)
        return traj

    def train_episode(nets, opt, gen, env, forest, hp):
        seen[0] += 1
        if seen[0] - 1 != pick:
            return real_episode(nets, opt, gen, env, forest, hp)
        names = [n for n, _ in nets.named_parameters()]
        state = {"params": {n: p.detach().clone()
                            for n, p in nets.named_parameters()},
                 "mu": dict(zip(names, (m.clone() for m in opt.mu))),
                 "nu": dict(zip(names, (v.clone() for v in opt.nu))),
                 "step": opt.step_count}
        mappo.rollout = rollout
        try:
            visited, stats = real_episode(nets, opt, gen, env, forest, hp)
        finally:
            mappo.rollout = real_rollout
        traj = box["traj"]
        caught.append(dict(
            state, wfeat=env.wfeat.clone(), config0=box["config0"].clone(),
            configs=traj.configs, actions=dict(traj.actions),
            forest=forest, loss=stats["loss"],
            after={n: p.detach().clone() for n, p in nets.named_parameters()}))
        return visited, stats

    mappo.train_episode = train_episode
    try:
        yield caught
    finally:
        mappo.train_episode = real_episode


def _cpu(x):
    """Tensors (in dicts, lists, tuples) moved to the host."""
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x.detach().cpu() if hasattr(x, "detach") else x


def _session(run, tasks, seed: int, pick=None) -> dict:
    """One session; its seconds (ended by a device synchronize), each
    task's report, the measured rows of its record file, its GBT's last
    forest and the MAPPO episode it was asked to keep."""
    import torch
    from repro_torch.compiler.session import Session
    from repro_torch.core.cost_model import GBTModel
    cfg = run.config
    model = GBTModel(n_rounds=cfg["gbt_rounds"], depth=cfg["gbt_depth"],
                     learning_rate=cfg["gbt_learning_rate"], seed=seed)
    with tempfile.TemporaryDirectory(prefix="dcoc_bench-") as d, \
            episode_caught(pick) as caught:
        path = os.path.join(d, "records.jsonl")
        t0 = time.perf_counter()
        rep = Session(tasks, tuner=tuner(cfg), algo=run.mix["algo"],
                      budget=budget(cfg), seed=seed, records=path,
                      gbt=model, device=run.device).run()
        if run.device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    reports = {r.task: {"best_latency": float(r.best_latency),
                        "best_config": list(r.best_config),
                        "n_measurements": int(r.n_measurements),
                        "multiplicity": int(r.multiplicity)}
               for r in rep}
    return {"seed": seed, "seconds": seconds, "reports": reports,
            "rows": rows, "forest": model.to_forest("cpu"),
            "episodes": caught}


def n_episodes(run, n_tasks: int) -> int:
    cfg = run.config
    return n_tasks * (cfg["iteration_opt"] - 1) * cfg["episodes_per_iter"]


def setup(run) -> None:
    tasks = _tasks(run)[:run.mix["warmup_tasks"]]
    _session(run, tasks, seed=run.seed * SEED_STRIDE + SEED_STRIDE - 1)


def window(run) -> None:
    from repro_torch import obs
    tasks = _tasks(run)
    tracer = obs.Tracer(name="dcoc_bench") if run.trace else None
    sessions = []
    with obs.use(tracer) if tracer else contextlib.nullcontext():
        t0 = time.perf_counter()
        while not sessions or time.perf_counter() - t0 < run.seconds:
            seed = run.seed * SEED_STRIDE + len(sessions)
            pick = (random.Random(seed).randrange(n_episodes(run, len(tasks)))
                    if run.mix["algo"] == "arco" else None)
            sessions.append(_session(run, tasks, seed, pick))
        window_s = time.perf_counter() - t0
    run.obs["sessions"] = _cpu(sessions)
    run.obs["spans"] = tracer.spans() if tracer else None
    run.obs["detail"] = {"window_s": window_s,
                         "session_s": [s["seconds"] for s in sessions],
                         "seeds": [s["seed"] for s in sessions]}
    run.attempted = len(sessions)
    run.failed = sum(1 for s in sessions for r in s["reports"].values()
                     if not r["best_config"]
                     or not r["best_latency"] < analytical.INFEASIBLE_S)


def trace(run) -> None:
    from repro_torch import obs
    import torch
    task = _tasks(run)[run.mix["profiled_task"]]
    tracer = spans.profiled_tracer()

    def go():
        with obs.use(tracer), torch.profiler.record_function("tuning"):
            _session(run, [task], run.seed * SEED_STRIDE + SEED_STRIDE - 2)

    run.devtrace = devtrace.profiled(go, "tuning", SPAN_NAMES)


def worst(*xs: float) -> float:
    """The largest of ``xs``; NaN where any is NaN (``max`` drops it)."""
    return float("nan") if any(x != x for x in xs) else max(xs)


def reference_latencies(wl: dict, rows, dtype) -> list:
    import torch
    values = analytical.decode(wl, [r["config"] for r in rows])
    return analytical.latency(wl, values, dtype).to(torch.float64).tolist()


def program_forest(forest) -> ref_gbt.Forest:
    """The program's forest in the reference's terms."""
    f = lambda a: np.asarray(a, np.float64)
    scale = float(forest.scale)
    return ref_gbt.Forest(np.asarray(forest.feat, np.int64),
                          f(forest.thresh), f(forest.leaf),
                          float(forest.base) * scale, scale,
                          float(forest.lr))


def gbt_gap(run, session, shapes, dtype) -> float:
    """Largest gap of the program's last forest to a reference fit on the
    session's measured rows, in the targets' standard deviations."""
    cfg, rows = run.config, session["rows"]
    x, lat = np.zeros((len(rows), 18)), np.zeros(len(rows))
    for task in {r["task"] for r in rows}:
        idx = [i for i, r in enumerate(rows) if r["task"] == task]
        wl = shapes[task][0]
        mine = [rows[i] for i in idx]
        x[idx] = ref_gbt.features(wl, [r["config"] for r in mine])
        lat[idx] = reference_latencies(wl, mine, dtype)
    y = -np.log(np.maximum(lat, 1e-12))
    prog = program_forest(session["forest"])
    ref = ref_gbt.fit(x, y, cfg["gbt_rounds"], cfg["gbt_depth"],
                      cfg["gbt_learning_rate"], follow=prog)
    want = ref_gbt.predict(ref, x)
    got = ref_gbt.predict(prog, x)
    return float(np.max(np.abs(got - want)) / (y.std() or 1.0))


def layer_of(wfeat, shapes) -> dict:
    """The workload whose layer features are the episode's."""
    w = np.asarray(wfeat, np.float64)
    wl = min((s[0] for s in shapes.values()),
             key=lambda wl: np.abs(ref_gbt.layer_features(wl) - w).max())
    if np.abs(ref_gbt.layer_features(wl) - w).max() > 1e-6:
        raise ValueError("the episode's layer is none of the network's")
    return wl


def reference_episode(run, ep: dict, shapes, tf32: bool = False) -> dict:
    """The reference's update of a kept episode."""
    start = ppo.episode(layer_of(ep["wfeat"], shapes), ep["config0"],
                        ep["configs"], ep["actions"],
                        program_forest(ep["forest"]))
    start.update(params=ep["params"], mu=ep["mu"], nu=ep["nu"],
                 step=ep["step"])
    out = ppo.update(start, hyper(run.config), tf32=tf32)
    out["moved_wrong"] = start["moved_wrong"]
    return out


def mappo_gaps(run, ep: dict, shapes):
    import torch
    ref = reference_episode(run, ep, shapes)
    if ref["moved_wrong"]:
        return math.inf, math.inf
    want = ref["losses"][-1]
    loss_gap = abs(float(ep["loss"]) - want) / abs(want)
    # elements whose gradient is nought to rounding move under Adam by
    # round-off alone: out by the reference's first gradient, under a
    # thousandth of the median element's
    grads = torch.cat([g.abs().flatten() for g in ref["first_grads"].values()])
    floor = 1e-3 * float(grads[grads > 0].median())
    num = den = 0.0
    for name, p0 in ep["params"].items():
        p0 = p0.to(torch.float64)
        keep = ref["first_grads"][name].abs() >= floor
        d_prog = ep["after"][name].to(torch.float64) - p0
        d_ref = ref["params"][name].to(torch.float64) - p0
        num += float(((d_prog - d_ref)[keep] ** 2).sum())
        den += float((d_ref[keep] ** 2).sum())
    return loss_gap, math.sqrt(num / den)


def gaps(run, dtype=None) -> dict:
    """The compared numbers over every session of the window; ``dtype``
    sets the analytical reference's precision (float64)."""
    import torch
    dtype = dtype or torch.float64
    shapes = {name: (conv.workload(run.mix["batch"]), mult)
              for name, conv, mult, _ in ref_tasks(run.config,
                                                   run.mix["batch"])}
    out = dict.fromkeys(("latency_gap", "best_gap", "network_gap",
                         "count_gap", "gbt_gap"), 0.0)
    if run.mix["algo"] == "arco":
        out.update(mappo_loss_gap=0.0, mappo_step_gap=0.0)
    for s in run.obs["sessions"]:
        by_task = {}
        for r in s["rows"]:
            by_task.setdefault(r["task"], []).append(r)
        net_prog = net_ref = 0.0
        for name, rep in s["reports"].items():
            wl, mult = shapes[name]
            rows = by_task.get(name, [])
            ref = reference_latencies(wl, rows, dtype) if rows else []
            for r, want in zip(rows, ref):
                out["latency_gap"] = worst(out["latency_gap"],
                                           abs(r["latency"] - want) / want)
            measured = min((r["latency"] for r in rows), default=math.inf)
            at_best = next((r["latency"] for r in rows
                            if r["config"] == rep["best_config"]), math.inf)
            out["best_gap"] = worst(out["best_gap"],
                                    abs(rep["best_latency"] - measured),
                                    abs(rep["best_latency"] - at_best))
            out["count_gap"] = worst(out["count_gap"], count_gap(
                run, wl, len(rows), rep["n_measurements"]))
            net_prog += rep["best_latency"] * rep["multiplicity"]
            net_ref += min(ref, default=math.inf) * mult
        out["network_gap"] = worst(out["network_gap"],
                                   abs(net_prog - net_ref) / net_ref)
        out["gbt_gap"] = worst(out["gbt_gap"],
                               gbt_gap(run, s, shapes, dtype))
        if run.mix["algo"] == "arco":
            loss_gap, step_gap = (mappo_gaps(run, s["episodes"][0], shapes)
                                  if s["episodes"] else (math.nan,) * 2)
            out["mappo_loss_gap"] = worst(out["mappo_loss_gap"], loss_gap)
            out["mappo_step_gap"] = worst(out["mappo_step_gap"], step_gap)
    return out


def check(run) -> None:
    run.checks = gaps(run)
