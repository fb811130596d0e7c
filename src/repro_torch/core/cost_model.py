"""Learned cost model: the ``modeGBT = xgb-reg`` analog of Table 4/5.

A gradient-boosted ensemble of fixed-depth regression trees, fit in numpy
on measured (configuration, fitness) pairs and exported as dense tensors,
so the prediction is a batched tensor gather usable *inside* the MARL
rollout as the surrogate reward.  The numpy fit is a copy of the
reference's (``_best_split``, ``_fit_tree``, ``GBTModel._fit``): the same
rows give the identical forest.

Trees are complete binary trees of depth ``depth``: internal node arrays
(feature index, threshold) plus a leaf-value array.  Degenerate nodes route
everything left with threshold=+inf.  The forest is refit from scratch on
all measurements each tuning iteration (as AutoTVM does), with a fixed
number of rounds so consumers never change shape.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class Forest(NamedTuple):
    """Dense forest; leaves are numpy arrays or tensors (``to``)."""
    feat: object    # (T, n_internal) int
    thresh: object  # (T, n_internal) float32
    leaf: object    # (T, n_leaves) float32
    base: object    # () float32 — mean target (normalized)
    scale: object   # () float32 — target std (denormalization)
    lr: object      # () float32

    def to(self, device) -> "Forest":
        """The forest as tensors on ``device`` (feature indices int64)."""
        t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt,
                                          device=device)
        return Forest(t(self.feat, torch.long), t(self.thresh, torch.float32),
                      t(self.leaf, torch.float32),
                      t(self.base, torch.float32),
                      t(self.scale, torch.float32), t(self.lr, torch.float32))


def empty_forest(n_rounds: int, depth: int) -> Forest:
    n_internal = 2 ** depth - 1
    return Forest(
        feat=np.zeros((n_rounds, n_internal), np.int32),
        thresh=np.full((n_rounds, n_internal), np.inf, np.float32),
        leaf=np.zeros((n_rounds, 2 ** depth), np.float32),
        base=np.float32(0.0), scale=np.float32(1.0), lr=np.float32(1.0))


def predict(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Forest prediction. x: (..., n_features) -> (...); ``forest`` holds
    tensors on x's device (``Forest.to``)."""
    n_trees, n_internal = forest.feat.shape
    depth = int(np.log2(forest.leaf.shape[-1]))
    flat = x.reshape(-1, x.shape[-1])
    trees = torch.arange(n_trees, device=x.device)
    idx = torch.zeros((flat.shape[0], n_trees), dtype=torch.long,
                      device=x.device)
    for _ in range(depth):  # all samples x all trees descend one level
        xv = torch.gather(flat, 1, forest.feat[trees, idx])
        go_right = xv > forest.thresh[trees, idx]
        idx = 2 * idx + 1 + go_right.long()
    vals = forest.leaf[trees, idx - n_internal]
    out = forest.base + forest.lr * vals.sum(dim=-1)
    return out.reshape(x.shape[:-1]) * forest.scale


# --------------------------------------------------------------------------
# numpy-side fitting (a copy of the reference's)
# --------------------------------------------------------------------------

def _best_split(Xn: np.ndarray, gn: np.ndarray, min_leaf: int):
    """Vectorized exact split search: sort + prefix sums per feature.

    Returns (gain, feature, threshold) or (0, None, None).
    SSE decomposition: sse = sum(g^2) - sum(g)^2/n per side.
    """
    n = len(gn)
    parent_sse = float(np.sum(gn * gn) - gn.sum() ** 2 / n)
    best_gain, best_f, best_t = 0.0, None, None
    for f in range(Xn.shape[1]):
        col = Xn[:, f]
        order = np.argsort(col, kind="stable")
        cs, gs = col[order], gn[order]
        csum = np.cumsum(gs)
        csum2 = np.cumsum(gs * gs)
        # valid split after position i (left = [0..i]) where value changes
        nl = np.arange(1, n)
        valid = (cs[1:] != cs[:-1]) & (nl >= min_leaf) & (n - nl >= min_leaf)
        if not valid.any():
            continue
        sl, sl2 = csum[:-1], csum2[:-1]
        sr, sr2 = csum[-1] - sl, csum2[-1] - sl2
        sse = (sl2 - sl * sl / nl) + (sr2 - sr * sr / (n - nl))
        sse = np.where(valid, sse, np.inf)
        i = int(np.argmin(sse))
        gain = parent_sse - float(sse[i])
        if gain > best_gain:
            best_gain, best_f = gain, f
            best_t = float((cs[i] + cs[i + 1]) / 2.0)
    return best_gain, best_f, best_t


def _fit_tree(X: np.ndarray, g: np.ndarray, depth: int, min_leaf: int = 4):
    """Greedy SSE regression tree on residuals g; returns dense arrays."""
    n_internal = 2 ** depth - 1
    n_leaves = 2 ** depth
    feat = np.zeros(n_internal, np.int32)
    thresh = np.full(n_internal, np.inf, np.float32)
    leaf = np.zeros(n_leaves, np.float32)

    # node -> sample indices; process level by level
    node_samples = {0: np.arange(len(g))}
    for node in range(n_internal):
        idx = node_samples.get(node, np.array([], np.int64))
        left, right = 2 * node + 1, 2 * node + 2
        if len(idx) < 2 * min_leaf:
            node_samples[left] = idx
            node_samples[right] = np.array([], np.int64)
            continue
        Xn, gn = X[idx], g[idx]
        _, f, t = _best_split(Xn, gn, min_leaf)
        if f is None:
            node_samples[left] = idx
            node_samples[right] = np.array([], np.int64)
            continue
        feat[node] = f
        thresh[node] = t
        mask = Xn[:, f] <= t
        node_samples[left] = idx[mask]
        node_samples[right] = idx[~mask]

    for l in range(n_leaves):
        idx = node_samples.get(n_internal + l, np.array([], np.int64))
        leaf[l] = float(g[idx].mean()) if len(idx) else 0.0
    return feat, thresh, leaf


def _np_tree_predict(feat, thresh, leaf, X, depth):
    n_internal = 2 ** depth - 1
    idx = np.zeros(len(X), np.int64)
    for _ in range(depth):
        go_right = X[np.arange(len(X)), feat[idx]] > thresh[idx]
        idx = 2 * idx + 1 + go_right.astype(np.int64)
    return leaf[idx - n_internal]


@dataclasses.dataclass
class GBTModel:
    """xgb-reg analog.  Fit in numpy, predict in torch via ``to_forest()``."""

    n_rounds: int = 40
    depth: int = 4
    learning_rate: float = 0.15
    n_features: int = 18

    def __post_init__(self):
        self._forest = empty_forest(self.n_rounds, self.depth)
        self._X: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None

    @property
    def n_samples(self) -> int:
        return 0 if self._X is None else len(self._X)

    def update(self, X: np.ndarray, y: np.ndarray) -> None:
        """Append measurements and refit from scratch (constant shapes)."""
        X = np.asarray(X, np.float32).reshape(-1, self.n_features)
        y = np.asarray(y, np.float32).reshape(-1)
        if self._X is None:
            self._X, self._y = X, y
        else:
            self._X = np.concatenate([self._X, X])
            self._y = np.concatenate([self._y, y])
        self._fit()

    def _fit(self) -> None:
        X, y = self._X, self._y
        scale = float(y.std()) or 1.0
        yn = (y - y.mean()) / scale
        pred = np.zeros_like(yn)
        feats, threshs, leaves = [], [], []
        for _ in range(self.n_rounds):
            f, t, l = _fit_tree(X, yn - pred, self.depth)
            feats.append(f)
            threshs.append(t)
            leaves.append(l)
            # dense re-predict via numpy traversal
            pred += self.learning_rate * _np_tree_predict(f, t, l, X,
                                                          self.depth)
        self._forest = Forest(
            feat=np.stack(feats), thresh=np.stack(threshs),
            leaf=np.stack(leaves),
            base=np.float32(y.mean() / scale), scale=np.float32(scale),
            lr=np.float32(self.learning_rate))

    def to_forest(self, device=None) -> Forest:
        """The current forest as tensors on ``device``."""
        return self._forest.to(device)

    def predict(self, X: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.array(X, np.float32))
        return predict(self.to_forest(), x).numpy()
