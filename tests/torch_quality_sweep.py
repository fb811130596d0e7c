"""Search quality of the port against the reference over many seeds.

    PYTHONPATH=src python tests/torch_quality_sweep.py [--seeds 16]

Runs ARCO in both packages on the CPU at the short-horizon setup of the
reference's ``test_arco_short_horizon_convergence_deterministic`` (conv
14x14x128->128, budget 160, decayed CS batches) for seeds 0..N-1 and
prints each run's best latency over the exhaustive optimum, and how many
seeds land within 25% of it.  Threefry and torch streams differ, so the
two packages are compared as distributions, not seed by seed.  Minutes
long: a script, not a tier-1 test.
"""
import argparse

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()
    torch.set_num_threads(1)  # tiny ops: one thread is fastest, and exact
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
