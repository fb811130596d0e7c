"""Plain gradient-boosted regression trees: the reference of the tuner's
surrogate refit.

The tuner's cost model, as it states it: an ensemble of ``rounds``
complete binary regression trees of depth ``depth``, fit on the targets
normalized by their mean and (population) standard deviation, each tree
to the residual the trees before it leave, its leaves scaled by the
learning rate.  A node is split by exact greedy search: over every
feature, the split between two neighbouring distinct values (the
threshold halfway between them; a row goes left where its value is at
most the threshold) with at least ``min_leaf`` rows on each side and the
least summed squared error, the first feature winning a tie; a node with
fewer than ``2 * min_leaf`` rows, or with no split that lowers the error,
sends every row left past an infinite threshold.  A leaf holds the mean
residual of its rows, 0 when it has none.  The forest predicts
``mean + std * lr * (sum of its leaves)``.

The features of a measured configuration are the log2 of each knob's
value over 16, then eleven of its layer (batch, size, channels, kernel,
stride and the GEMM's M, N, K), likewise.

Exact ties happen: the tuner's layers make different knobs split the
rows into groups of equal error (AutoTVM's held hardware knobs and the
layer's own features both split by layer), and the float32 search breaks
such a tie by its rounding.  So :func:`fit` may be given the forest under
judgment to ``follow``: at each node, where that forest's split errs by
no more than ``tol`` of the node's error above the best split, the
reference takes it; anywhere else it takes its own.  A forest fit as
stated is then followed split for split and agrees to rounding; one fit
on other rows or targets departs at its first wrong split.

Plain NumPy, in float64 (or, for the control, with every input, residual
and leaf rounded to bfloat16); it imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np

from dcoc_bench.reference import analytical

MIN_LEAF = 4


class Forest(NamedTuple):
    feat: np.ndarray     # (rounds, 2**depth - 1) int
    thresh: np.ndarray   # (rounds, 2**depth - 1)
    leaf: np.ndarray     # (rounds, 2**depth)
    mean: float
    std: float
    lr: float


def to_bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    f = np.asarray(a, np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def layer_features(wl: Dict[str, int]) -> np.ndarray:
    oh, ow = analytical.out_hw(wl)
    raw = [wl["b"], wl["h"], wl["w"], wl["ci"], wl["co"], wl["kh"],
           wl["kw"], wl["stride"], wl["b"] * oh * ow, wl["co"],
           wl["ci"] * wl["kh"] * wl["kw"]]
    return np.log2(np.maximum(np.array(raw, np.float64), 1.0)) / 16.0


def features(wl: Dict[str, int], configs: Sequence[Sequence[int]]
             ) -> np.ndarray:
    """(n, 18) features of the configurations (choice indices) of ``wl``."""
    values = analytical.decode(wl, configs).numpy().astype(np.float64)
    knobs = np.log2(np.maximum(values, 1.0)) / 16.0
    layer = np.broadcast_to(layer_features(wl), (len(knobs), 11))
    return np.concatenate([knobs, layer], axis=1)


def _split(x: np.ndarray, r: np.ndarray):
    """(error, feature, threshold) of the node's best split, or None."""
    n = len(r)
    best = None
    base = float(np.sum((r - r.mean()) ** 2))
    nl = np.arange(1, n)           # rows left of a split after row nl - 1
    for f in range(x.shape[1]):
        order = np.argsort(x[:, f], kind="stable")
        xs, rs = x[order, f], r[order]
        s1, s2 = np.cumsum(rs)[:-1], np.cumsum(rs * rs)[:-1]
        t1, t2 = rs.sum(), (rs * rs).sum()
        err = (s2 - s1 ** 2 / nl) + ((t2 - s2) - (t1 - s1) ** 2 / (n - nl))
        ok = (xs[1:] != xs[:-1]) & (nl >= MIN_LEAF) & (n - nl >= MIN_LEAF)
        if not ok.any():
            continue
        i = int(np.argmin(np.where(ok, err, np.inf)))
        if err[i] < base and (best is None or err[i] < best[0]):
            best = (float(err[i]), f, (xs[i] + xs[i + 1]) / 2.0)
    return best


def _error(x: np.ndarray, r: np.ndarray, f: int, t: float):
    """Summed squared error of the split (f, t), None where a side has
    fewer than MIN_LEAF rows."""
    left = x[:, f] <= t
    if min(left.sum(), (~left).sum()) < MIN_LEAF:
        return None
    return float(((r[left] - r[left].mean()) ** 2).sum()
                 + ((r[~left] - r[~left].mean()) ** 2).sum())


def _tree(x: np.ndarray, r: np.ndarray, depth: int, follow=None,
          tol: float = 0.0):
    n_int = 2 ** depth - 1
    feat = np.zeros(n_int, np.int64)
    thresh = np.full(n_int, np.inf)
    rows = {0: np.arange(len(r))}
    for node in range(n_int):
        idx = rows.pop(node)
        found = _split(x[idx], r[idx]) if len(idx) >= 2 * MIN_LEAF else None
        if follow is not None and found is not None \
                and np.isfinite(follow[1][node]):
            f, t = int(follow[0][node]), float(follow[1][node])
            err = _error(x[idx], r[idx], f, t)
            base = float(((r[idx] - r[idx].mean()) ** 2).sum())
            if err is not None and err <= found[0] + tol * base:
                found = (err, f, t)
        if found is None:
            rows[2 * node + 1], rows[2 * node + 2] = idx, idx[:0]
            continue
        _, feat[node], thresh[node] = found
        go_left = x[idx, feat[node]] <= thresh[node]
        rows[2 * node + 1], rows[2 * node + 2] = idx[go_left], idx[~go_left]
    leaf = np.array([r[rows[n_int + j]].mean() if len(rows[n_int + j])
                     else 0.0 for j in range(n_int + 1)])
    return feat, thresh, leaf


def leaves(feat, thresh, leaf, x: np.ndarray) -> np.ndarray:
    """Each row's leaf value in each tree, (rounds, n)."""
    depth = int(np.log2(np.shape(leaf)[-1]))
    out = []
    for f, t, l in zip(feat, thresh, leaf):
        node = np.zeros(len(x), np.int64)
        for _ in range(depth):
            right = x[np.arange(len(x)), f[node]] > t[node]
            node = 2 * node + 1 + right
        out.append(l[node - (2 ** depth - 1)])
    return np.array(out)


def fit(x, y, rounds: int, depth: int = 4, lr: float = 0.15,
        bf16: bool = False, follow: Forest = None,
        tol: float = 1e-6) -> Forest:
    """The forest of ``rounds`` trees on rows ``x``, targets ``y``; where
    ``follow`` is given, its splits are taken wherever they err by no
    more than ``tol`` of a node's error above the best."""
    rnd = to_bf16 if bf16 else (lambda a: np.asarray(a, np.float64))
    x, y = rnd(x), rnd(y)
    mean, std = float(y.mean()), float(y.std()) or 1.0
    target = rnd((y - mean) / std)
    pred = np.zeros_like(target)
    trees = []
    for i in range(rounds):
        guide = None if follow is None else (follow.feat[i], follow.thresh[i])
        feat, thresh, leaf = _tree(x, rnd(target - pred), depth, guide, tol)
        leaf = rnd(leaf)
        trees.append((feat, thresh, leaf))
        pred = rnd(pred + lr * leaves([feat], [thresh], [leaf], x)[0])
    feat, thresh, leaf = (np.stack(a) for a in zip(*trees))
    return Forest(feat, thresh, leaf, mean, std, lr)


def predict(forest: Forest, x: np.ndarray) -> np.ndarray:
    return forest.mean + forest.std * forest.lr * leaves(
        forest.feat, forest.thresh, forest.leaf, x).sum(axis=0)
