"""Confidence Sampling (CS) — Algorithm 2 of the paper.

Replaces uniform/adaptive sampling when choosing which explored
configurations get real (expensive) measurements:

  1. value-network scores for all candidates            (critic predictions)
  2. softmax -> probability distribution; probability-guided selection
  3. dynamic threshold = median of predicted values
  4. low-confidence picks are *replaced by synthesized* configs built from
     each knob's most frequent setting among the sampled configurations

Runs between episodes on small arrays — plain numpy for clarity.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def softmax(x: np.ndarray) -> np.ndarray:
    z = x - x.max()
    e = np.exp(z)
    return e / e.sum()


def select_configurations(probs: np.ndarray, n: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Probability-guided selection (Alg. 2 SelectConfigurations).

    Gumbel top-k == sampling *without* replacement proportional to probs,
    which avoids burning measurement budget on duplicates.
    """
    n = min(n, len(probs))
    g = rng.gumbel(size=len(probs))
    keys = np.log(np.maximum(probs, 1e-12)) + g
    return np.argsort(-keys)[:n]


def compute_dynamic_threshold(v_preds: np.ndarray) -> float:
    return float(np.median(v_preds))


def synthesize(configs: np.ndarray, n_choices: np.ndarray,
               rng: np.random.Generator, n: int) -> np.ndarray:
    """Mode-synthesis: per-knob most frequent setting, with ±1 jitter so
    multiple synthesized configs are not all identical."""
    modes = np.empty(configs.shape[1], np.int64)
    for k in range(configs.shape[1]):
        vals, counts = np.unique(configs[:, k], return_counts=True)
        modes[k] = vals[np.argmax(counts)]
    out = np.tile(modes, (n, 1))
    if n > 1:
        jit = rng.integers(-1, 2, size=out.shape)
        jit[0] = 0  # keep the pure mode config
        out = out + jit
    return np.clip(out, 0, np.asarray(n_choices) - 1)


def confidence_sampling(configs: np.ndarray, v_preds: np.ndarray,
                        n_configs: int, n_choices: np.ndarray,
                        seed: int = 0) -> np.ndarray:
    """Full Algorithm 2. Returns unique configs to measure, <= n_configs."""
    configs = np.asarray(configs)
    v_preds = np.asarray(v_preds, np.float64)
    rng = np.random.default_rng(seed)

    probs = softmax(v_preds)                                   # line 3
    sel = select_configurations(probs, n_configs, rng)         # line 4
    threshold = compute_dynamic_threshold(v_preds)             # line 5
    high = sel[v_preds[sel] > threshold]                       # line 6
    n_low = len(sel) - len(high)

    chosen = configs[high]
    if n_low > 0:                                              # line 7
        basis = configs[high] if len(high) else configs[sel]
        chosen = np.concatenate([chosen, synthesize(basis, n_choices, rng,
                                                    n_low)])
    return np.unique(chosen, axis=0)
