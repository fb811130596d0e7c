"""Fault-tolerant training loop (the reference's ``repro.train.trainer``).

Failure model and the response here:

  * hardware/process crash      -> restart + restore the latest checkpoint;
                                   the data pipeline is step-addressed, so
                                   resume is exact with no replay log;
  * loss NaN / grad explosion   -> automatic rollback to the last
                                   checkpoint (``FloatingPointError``);
  * stragglers                  -> a bounded prefetch queue decouples input
                                   production from the step cadence.

``FailureInjector`` scripts crashes and NaNs deterministically.  Its NaN
batch carries out-of-range token ids; the embedding gives NaN rows for
them (``jnp.take``'s fill, :func:`repro_torch.models.transformer.embed`),
never an out-of-range gather, so on the card the rollback finds a usable
CUDA context.

On one device, or over a ``DeviceMesh`` (``mesh=``, with ``rules``): the
parameters and moments are then DTensors placed by the sharding rules,
the step is ``build_sharded_train_step``'s, every rank builds the
step-addressed global batch and the step places it by ``batch_specs``,
and checkpoints are gathered whole (rank 0 writes) and restored into each
rank's shards.  Every rank runs the same loop: a crash or a NaN loss
(the loss is a global mean, so every rank sees it) rolls all of them
back together.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.dist import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.steps import (TrainConfig, build_sharded_train_step,
                                     make_optimizer, train_step_fn)


class FailureInjector:
    """Deterministic fault scripting for tests."""

    def __init__(self, crash_at: Optional[int] = None,
                 nan_at: Optional[int] = None):
        self.crash_at = crash_at
        self.nan_at = nan_at
        self.fired: List[str] = []

    def maybe_fail(self, step: int, batch: Dict[str, np.ndarray]):
        if self.crash_at is not None and step == self.crash_at:
            self.crash_at = None
            self.fired.append(f"crash@{step}")
            raise RuntimeError(f"injected crash at step {step}")
        if self.nan_at is not None and step == self.nan_at:
            self.nan_at = None
            self.fired.append(f"nan@{step}")
            bad = dict(batch)
            bad["tokens"] = np.full_like(batch["tokens"], -(2 ** 31) + 7)
            return bad
        return batch


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    nan_check_every: int = 1
    max_restarts: int = 3


class Trainer:
    """The trainer: ``init_params(tc.seed)`` or the latest checkpoint under
    ``trc.ckpt_dir``, then :meth:`run`.  Runs on ``cuda`` unless ``device``
    names another (``device="cpu"``); without CUDA it raises rather than
    fall back.  ``mesh``: a ``DeviceMesh`` (``launch.mesh.make_device_mesh``)
    to train over with ``rules``; its device type is then the device."""

    def __init__(self, cfg: T.ArchConfig, tc: TrainConfig,
                 trc: TrainerConfig, device=None,
                 data_cfg: Optional[DataConfig] = None,
                 injector: Optional[FailureInjector] = None, mesh=None,
                 rules: SH.ShardingRules = SH.ShardingRules()):
        self.cfg, self.tc, self.trc = cfg, tc, trc
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.injector = injector
        self.metrics_log: List[Dict[str, Any]] = []
        self.restarts = 0

        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=256, global_batch=8, seed=tc.seed)
        self.ds = SyntheticLM(self.data_cfg)
        self.ckpt = CKPT.CheckpointManager(trc.ckpt_dir, keep=trc.keep)

        self.params = T.init_params(tc.seed, cfg, device=self.device)
        if mesh is None:
            self._step_fn = train_step_fn(cfg, tc)
        else:
            make, sh = build_sharded_train_step(cfg, tc, mesh, rules)
            self.params = SH.distribute_tree(self.params, sh["params"], mesh)
            self._step_fn = make(self.ds.batch_at(0))
        self.opt = make_optimizer(tc, self.params)
        latest = self.ckpt.latest_step()
        self.step = 0
        if latest is not None:
            self._restore(latest)

    # ------------------------------------------------------------- state
    def _tree(self) -> Dict[str, Any]:
        """The checkpoint's tree: the live parameters and moments (the
        moments keyed like the parameters) and the optimizer's step."""
        state = self.opt.state_dict()
        names = [k for k, _ in CKPT.flatten(self.params)]

        def named(tensors):
            tree: Dict[str, Any] = {}
            for name, t in zip(names, tensors):
                node = tree
                *path, leaf = name.split("/")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = t
            return tree

        step = torch.tensor(state["step"], dtype=torch.int32)
        return {"params": self.params,
                "opt": {"step": step, "mu": named(state["mu"]),
                        "nu": named(state["nu"])}}

    def _restore(self, step: int) -> None:
        """Copy checkpoint ``step`` into the live tensors on the device:
        the parameters in place, the moments and step count through
        ``Adam.load_state_dict``."""
        _, flat, meta = CKPT.restore(self.trc.ckpt_dir, step)
        CKPT.copy_into({"params": self.params}, flat)
        names = [k for k, _ in CKPT.flatten(self.params)]
        self.opt.load_state_dict({
            "step": int(flat["opt/step"]),
            **{m: [flat[f"opt/{m}/{k}"] for k in names]
               for m in ("mu", "nu")}})
        self.step = int(meta["data_step"])

    def _save(self, sync: bool = False) -> None:
        tree, meta = self._tree(), {"data_step": self.step}
        if sync:
            self.ckpt.save_sync(self.step, tree, meta)
        else:
            self.ckpt.save_async(self.step, tree, meta)

    # -------------------------------------------------------------- loop
    def run(self) -> List[Dict[str, Any]]:
        self._save(sync=True)  # step-0 anchor
        prefetch = Prefetcher(self.ds, start_step=self.step)
        try:
            while self.step < self.trc.steps:
                try:
                    batch = prefetch.next()
                    if self.injector:
                        batch = self.injector.maybe_fail(self.step, batch)
                    t0 = time.perf_counter()
                    metrics = self._step_fn(self.params, self.opt, batch)
                    loss = float(metrics["loss"])
                    if (self.step % self.trc.nan_check_every == 0
                            and not math.isfinite(loss)):
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}: {loss}")
                    dt = time.perf_counter() - t0
                    if self.step % self.trc.log_every == 0:
                        self.metrics_log.append(
                            {"step": self.step, "loss": loss,
                             "grad_norm": float(metrics["grad_norm"]),
                             "sec": dt})
                    self.step += 1
                    if self.step % self.trc.ckpt_every == 0:
                        self._save()
                except (RuntimeError, FloatingPointError) as e:
                    self.restarts += 1
                    if self.restarts > self.trc.max_restarts:
                        raise
                    self.ckpt.wait()
                    self._restore(self.ckpt.latest_step())
                    prefetch.close()
                    prefetch = Prefetcher(self.ds, start_step=self.step)
                    self.metrics_log.append(
                        {"step": self.step, "event": f"rollback({e})"})
        finally:
            prefetch.close()
            self.ckpt.wait()
        self._save(sync=True)
        return self.metrics_log
