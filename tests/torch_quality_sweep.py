"""Search quality of the port against the reference over many seeds.

    PYTHONPATH=src python tests/torch_quality_sweep.py [--seeds 16]
    PYTHONPATH=src python tests/torch_quality_sweep.py --bar transfer

``--bar arco`` (the default) runs ARCO in both packages on the CPU at the
short-horizon setup of the reference's
``test_arco_short_horizon_convergence_deterministic`` (conv
14x14x128->128, budget 160, decayed CS batches) for seeds 0..N-1 and
prints each run's best latency over the exhaustive optimum, and how many
seeds land within 25% of it.  ``--bar transfer`` runs the setup of the
reference's ``test_netopt_transfer_stats_and_warm_seeding`` (network B
co-optimized after network A saved its surrogate rows, against the
hw-frozen baseline at equal budget) and prints, per seed, whether the
co-optimizer won.  Threefry and torch streams differ, so the two packages
are compared as distributions, not seed by seed.  Minutes long: a script,
not a tier-1 test.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro.core import mappo as JM
from repro.core.design_space import DesignSpace as JDS
from repro.core.tuner import TunerConfig as JTunerConfig
from repro.core.tuner import arco_tune as j_arco_tune
from repro_torch.core import mappo as TM
from repro_torch.core.design_space import DesignSpace as TDS
from repro_torch.core.tuner import TunerConfig as TTunerConfig
from repro_torch.core.tuner import arco_tune as t_arco_tune

WL = dict(b=1, h=14, w=14, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)


def _config(tuner_config, mappo, seed):
    return tuner_config(iteration_opt=5, b_measure=32, episodes_per_iter=3,
                        mappo=mappo.MappoConfig(n_steps=48, n_envs=16),
                        gbt_rounds=20, seed=seed, b_growth=0.6)


def _transfer_win(pkg: str, seed: int) -> bool:
    """One seed of the transfer bar in the reference (``pkg="reference"``)
    or the port: does network B's co-optimization, warm-started from
    network A's store, beat the hw-frozen baseline at equal budget?"""
    if pkg == "reference":
        from repro.compiler import netopt as N
        from repro.compiler.task import TuningTask
        from repro.core import mappo
        from repro.core.design_space import DesignSpace
        from repro.core.tuner import TunerConfig
        kw = {}
    else:
        from repro_torch.compiler import netopt as N
        from repro_torch.compiler.task import TuningTask
        from repro_torch.core import mappo
        from repro_torch.core.design_space import DesignSpace
        from repro_torch.core.tuner import TunerConfig
        kw = {"device": "cpu"}
    wl = lambda ci, co, h: dict(b=1, h=h, w=h, ci=ci, co=co, kh=3, kw=3,
                                stride=1, pad=1)

    def net(name, *wls):
        return [TuningTask.from_space(f"{name}{i}",
                                      DesignSpace.for_conv2d(w))
                for i, w in enumerate(wls)]

    tiny = TunerConfig(iteration_opt=2, b_measure=6, episodes_per_iter=2,
                       mappo=mappo.MappoConfig(n_steps=12, n_envs=8),
                       gbt_rounds=8, seed=seed)
    cfg = N.NetOptConfig(seed_candidates=3, hw_rounds=1, hw_per_round=1,
                         layer_budget=6, refine_budget=4, tuner=tiny,
                         seed=seed)
    store = os.path.join(tempfile.mkdtemp(), "surr.jsonl")
    N.NetworkCoOptimizer(net("a", wl(256, 256, 14), wl(128, 128, 28)), cfg,
                         name="netA", surrogates=store, **kw).run()
    net_b = net("b", wl(128, 256, 14), wl(128, 256, 28))
    rb = N.NetworkCoOptimizer(net_b, cfg, name="netB", surrogates=store,
                              **kw).run()
    frozen = N.network_hw_frozen_tune(net_b, cfg, name="netB-frozen",
                                      surrogates=store, **kw)
    return rb.network_latency <= frozen.network_latency


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--bar", choices=("arco", "transfer"), default="arco")
    args = ap.parse_args()
    torch.set_num_threads(1)  # tiny ops: one thread is fastest, and exact
    if args.bar == "transfer":
        wins = {"port": [], "reference": []}
        for seed in range(args.seeds):
            for pkg in wins:
                if _transfer_win(pkg, seed):
                    wins[pkg].append(seed)
            won = {p: "win" if seed in w else "loss" for p, w in wins.items()}
            print(f"seed {seed}: port {won['port']}  reference "
                  f"{won['reference']}", flush=True)
        for pkg, won in wins.items():
            print(f"{pkg}: co-opt <= hw-frozen on {len(won)}/{args.seeds} "
                  f"seeds; lost {sorted(set(range(args.seeds)) - set(won))}")
        return
    tspace, jspace = TDS.for_conv2d(WL), JDS.for_conv2d(WL)
    grids = np.meshgrid(*[np.arange(len(c)) for c in tspace.choices],
                        indexing="ij")
    optimum = float(tspace.measure(torch.as_tensor(
        np.stack([g.reshape(-1) for g in grids], 1))).min())
    port, ref = [], []
    for seed in range(args.seeds):
        port.append(t_arco_tune(tspace, _config(TTunerConfig, TM, seed),
                                budget=160, device="cpu").best_latency
                    / optimum)
        ref.append(j_arco_tune(jspace, _config(JTunerConfig, JM, seed),
                               budget=160).best_latency / optimum)
        print(f"seed {seed}: port {port[-1]:.3f}x  reference {ref[-1]:.3f}x",
              flush=True)
    for name, rs in (("port", port), ("reference", ref)):
        print(f"{name}: within 25% on {sum(r <= 1.25 for r in rs)}/"
              f"{len(rs)} seeds, median {float(np.median(rs)):.3f}x")


if __name__ == "__main__":
    main()
