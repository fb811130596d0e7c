"""Readings that set a cell's limits: the program's on many seeds, and the
control's, the reference put in the program's place one precision below
what the configuration states.

    python3 dcoc_bench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--seconds 3] [--first-seed N] [--fault NAME]

on the card, at the cell's own size and load, in one process.  Each seed
builds the cell as a run does and runs a short window of the program,
then the same window with the control in its place, and prints one JSON
line a side with every compared number; the last line gives, per number,
the largest program reading and the least control reading.  With
``--fault NAME`` every seed runs the program with one of :data:`FAULTS`
planted, and the lines give its readings.

The control: for ``closed_loop_forward`` the plain reference forward with
every conv's and the head's operands rounded to float8 e4m3 (bfloat16 is
stated); for ``tune_sessions`` the references in the program's place,
each one precision below the float32 the tuner states: the analytical
model computed in bfloat16 in the oracle's place, the GBT fit in
bfloat16 in the surrogate refit's, and (ARCO) the MAPPO update with its
matrix products in TF32 in the episode's update.  The benchmark's own
runs never run it.
"""
import argparse
import contextlib
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from dcoc_bench import harness  # noqa: E402


def _no_step(self, grads=None):
    self.step_count += 1


def _half_rollout(nets, traj, advs, returns, env, hp):
    from repro_torch.core import mappo
    e = traj.rewards.shape[1] // 2
    cut = lambda x: ({k: v[:, :e] for k, v in x.items()}
                     if isinstance(x, dict) else x[:, :e])
    half = mappo.Trajectory(*[cut(f) for f in traj[:-1]],
                            traj.last_value[:e])
    return _REAL["ppo_loss"](nets, half, advs[:, :e], returns[:, :e], env,
                             hp)


def _refit_once(self):
    if not getattr(self, "_fitted_once", False):
        self._fitted_once = True
        _REAL["_fit"](self)


def _refit_half_rows(self):
    x, y = self._X, self._y
    self._X, self._y = x[::2], y[::2]
    try:
        _REAL["_fit"](self)
    finally:
        self._X, self._y = x, y


_REAL = {}
# faults a tune cell can have, planted in the program: (module, class,
# attribute, replacement, the number that has to catch it)
FAULTS = {
    # the agents' state left unchanged by every update
    "agents_unchanged": ("repro_torch.optim.adam", "Adam", "step", _no_step,
                         "mappo_step_gap"),
    # the update's loss a mean over half the rollout's environments
    "update_on_half_the_batch": ("repro_torch.core.mappo", None, "ppo_loss",
                                 _half_rollout, "mappo_loss_gap"),
    # the surrogate fit once, on the first batch, and never refit
    "refit_skipped": ("repro_torch.core.cost_model", "GBTModel", "_fit",
                      _refit_once, "gbt_gap"),
    # the surrogate refit on every other measured row
    "refit_on_half_the_rows": ("repro_torch.core.cost_model", "GBTModel",
                               "_fit", _refit_half_rows, "gbt_gap"),
}


@contextlib.contextmanager
def planted(fault: str):
    """The program with one of :data:`FAULTS` in it."""
    module, cls, attr, fn, _ = FAULTS[fault]
    owner = importlib.import_module(module)
    owner = getattr(owner, cls) if cls else owner
    real = _REAL[attr] = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, real)


@contextlib.contextmanager
def bf16_oracle():
    """The analytical oracle's measurements made by the reference model
    in bfloat16."""
    import numpy as np
    import torch
    from repro_torch.compiler.oracle import AnalyticalOracle
    from dcoc_bench.reference import analytical

    def measure(self, configs):
        wl = self.space.workload
        lat = analytical.latency(wl, analytical.decode(wl, configs),
                                 torch.bfloat16)
        return (lat.to(torch.float64).numpy(),
                self.features(configs).astype(np.float32), None)

    old = AnalyticalOracle._measure_batch
    AnalyticalOracle._measure_batch = measure
    try:
        yield
    finally:
        AnalyticalOracle._measure_batch = old


@contextlib.contextmanager
def bf16_refit():
    """The surrogate refit made by the reference GBT in bfloat16."""
    import numpy as np
    from repro_torch.core import cost_model
    from dcoc_bench.reference import gbt

    def fit(self):
        f = gbt.fit(self._X, self._y, self.n_rounds, self.depth,
                    self.learning_rate, bf16=True)
        self._forest = cost_model.Forest(
            f.feat.astype(np.int32), f.thresh.astype(np.float32),
            f.leaf.astype(np.float32), np.float32(f.mean / f.std),
            np.float32(f.std), np.float32(f.lr))

    old = cost_model.GBTModel._fit
    cost_model.GBTModel._fit = fit
    try:
        yield
    finally:
        cost_model.GBTModel._fit = old


@contextlib.contextmanager
def tf32_update(run):
    """Each MAPPO episode's update made by the reference with its matrix
    products in TF32, after the program's own rollout."""
    import torch
    from repro_torch.core import mappo
    tune = harness.generator("tune_sessions")
    shapes = {name: (conv.workload(run.mix["batch"]), mult)
              for name, conv, mult, _ in tune.ref_tasks(run.config,
                                                        run.mix["batch"])}

    def episode(nets, opt, gen, env, forest, hp):
        u = torch.rand((hp.n_envs, 7), generator=gen, device=gen.device)
        config0 = (u * env.n_choices).long()
        traj = mappo.rollout(nets, gen, env, forest, config0, hp)
        names = [n for n, _ in nets.named_parameters()]
        ep = {"params": dict(nets.named_parameters()),
              "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)),
              "step": opt.step_count, "wfeat": env.wfeat, "config0": config0,
              "configs": traj.configs, "actions": traj.actions,
              "forest": forest}
        out = tune.reference_episode(run, tune._cpu(ep), shapes, tf32=True)
        with torch.no_grad():
            for name, p in nets.named_parameters():
                p.copy_(out["params"][name])
            for m, v, name in zip(opt.mu, opt.nu, names):
                m.copy_(out["mu"][name])
                v.copy_(out["nu"][name])
        opt.step_count = out["step"]
        return (traj.configs.reshape(-1, 7),
                {"loss": torch.tensor(out["losses"][-1])})

    old = mappo.train_episode
    mappo.train_episode = episode
    try:
        yield
    finally:
        mappo.train_episode = old


def control_side(run) -> dict:
    """The window again with the control in the program's place; its
    compared numbers."""
    gen = harness.generator(run.mix["kind"])
    if run.mix["kind"] == "closed_loop_forward":
        from dcoc_bench.reference import cnn as ref_cnn
        w = run.state["weights"]
        run.state["forward"] = lambda x: ref_cnn.forward(
            run.config, w["conv_w"], w["conv_b"], w["fc_w"], w["fc_b"], x,
            quant="fp8")
        gen.window(run)
    else:
        with bf16_oracle(), bf16_refit(), tf32_update(run):
            gen.window(run)
    gen.check(run)
    return dict(run.checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    harness.require_chips(1)
    program, control = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        run = harness.make_run(args.workload, seed, args.seconds, False)
        t0 = time.perf_counter()
        with planted(args.fault) if args.fault else contextlib.nullcontext():
            harness.execute(run, t0)
        side = "fault:" + args.fault if args.fault else "program"
        sides = [(side, dict(run.checks))]
        if i < args.control_seeds and not args.fault:
            sides.append(("control", control_side(run)))
        for side, checks in sides:
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "side": side, "checks": checks,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            into = control if side == "control" else program
            for k, v in checks.items():
                into.setdefault(k, []).append(v)
        del run
        torch.cuda.empty_cache()
    print(json.dumps({"cell": args.workload,
                      "program_max": {k: max(v) for k, v in program.items()},
                      "control_min": {k: min(v) for k, v in control.items()},
                      "seeds": args.seeds,
                      "control_seeds": args.control_seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
