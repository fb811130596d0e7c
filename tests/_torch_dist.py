"""Multi-rank CPU runs of the port's mesh paths for the ``test_torch_*``
files: ``world`` spawned processes over gloo, rendezvous through a
``FileStore`` in the test's ``tmp_path`` (no port is bound), every wait
bounded.  Each job runs all of one setup's checks in one spawn and returns
per-rank results that the tests parametrise over.  This module imports
only torch and the port: a spawned rank never loads jax."""
import datetime
import os
import time
import traceback

import numpy as np
import torch

RESULT = "rank{}.pt"


def run_ranks(job: str, world: int, tmp_path, timeout: float = 240,
              **kw) -> list:
    """``JOBS[job](rank, world, tmp, **kw)`` in ``world`` spawned processes;
    returns each rank's result.  A rank that raises fails the call with
    its traceback; one that outlives ``timeout`` seconds is killed."""
    import torch.multiprocessing as mp
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(job, world, tmp, kw),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job}: {world} ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, RESULT.format(r)),
                       weights_only=False) for r in range(world)]


def _entry(rank: int, job: str, world: int, tmp: str, kw: dict) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = JOBS[job](rank, world, tmp, **kw)
        torch.save(out, os.path.join(tmp, RESULT.format(rank)))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ jobs

def _fp32(cfg):
    return cfg.with_(dtype=torch.float32, param_dtype=torch.float32)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


# the sharded-steps cases: (name, mesh, ShardingRules kwargs, grad_accum).
# (1, 4) shards wk/wv's 32 columns 8 a rank, mid-head (head_dim 16);
# FSDP's threshold is lowered so the reduced model's weights shard too
SHARDED_CASES = (
    ("2x2", {"data": 2, "model": 2}, {}, 1),
    ("4x1", {"data": 4, "model": 1}, {}, 1),
    ("1x4", {"data": 1, "model": 4}, {}, 1),
    ("2x2-fsdp", {"data": 2, "model": 2},
     {"fsdp_weights": True, "fsdp_min_size": 64}, 1),
    ("2x2-sp", {"data": 2, "model": 2}, {"sequence_parallel": True}, 1),
    ("2x2-accum", {"data": 2, "model": 2}, {}, 2),
)


def sharded_steps(rank: int, world: int, tmp: str) -> dict:
    """Reduced qwen2-1.5b in fp32 on each of :data:`SHARDED_CASES`: one
    ``build_sharded_train_step`` step beside the unsharded
    ``train_step_fn``'s at the same ``grad_accum`` (loss, grad norm, every
    updated parameter, the
    local shards' shapes, the moments' placements), then
    ``build_sharded_prefill`` and 3 ``build_sharded_serve_step`` steps
    beside ``prefill`` / ``decode_step``."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.train import steps as S
    cfg = _fp32(get_config("qwen2-1.5b", reduced=True))
    tcs = {n: S.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_accum=n) for n in (1, 2)}
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (4, 32), generator=gen)}
    prompts = {"tokens": torch.randint(0, cfg.vocab, (4, 24), generator=gen)}
    decode = [torch.randint(0, cfg.vocab, (4, 1), generator=gen)
              for _ in range(3)]
    max_len = 40

    unsharded = {n: _unsharded_train(cfg, tc, batch)
                 for n, tc in tcs.items()}
    serve0 = _unsharded_serve(cfg, prompts, decode, max_len)
    out = {}
    for name, shape, rules_kw, accum in SHARDED_CASES:
        out[name] = _sharded_vs_unsharded(
            cfg, tcs[accum], shape, SH.ShardingRules(**rules_kw), batch,
            prompts, decode, max_len, unsharded[accum], serve0)
    return out


def _unsharded_train(cfg, tc, batch) -> tuple:
    """``init_params(0)`` after one unsharded ``train_step_fn`` step: the
    parameters, the optimizer and the step's metrics."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    p0 = T.init_params(0, cfg, device="cpu")
    opt = S.make_optimizer(tc, p0)
    return p0, opt, S.train_step_fn(cfg, tc)(p0, opt, batch)


def _unsharded_serve(cfg, prompts, decode, max_len) -> tuple:
    """``init_params(0)``, and from it the unsharded prefill's logits and
    a decode step's a token of ``decode``."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    p_init = T.init_params(0, cfg, device="cpu")
    logits0, cache0 = S.prefill_fn(cfg, max_len)(p_init, prompts)
    step0 = S.serve_step_fn(cfg)
    dec0 = []
    for tok in decode:
        out, cache0 = step0(p_init, cache0, tok)
        dec0.append(out)
    return p_init, logits0, dec0


def _sharded_vs_unsharded(cfg, tc, shape, rules, batch, prompts, decode,
                          max_len, unsharded, serve0) -> dict:
    """One ``build_sharded_train_step`` step, ``build_sharded_prefill`` and
    a ``build_sharded_serve_step`` step a token of ``decode`` on ``shape``,
    against the unsharded step (``unsharded``: the parameters, optimizer
    and metrics :func:`_unsharded_train` gives) and the unsharded prefill's
    and decode steps' logits (``serve0``: :func:`_unsharded_serve`'s), all
    from the parameters ``init_params(0)``.

    Beside the largest parameter error against the model's largest
    parameter (``param_err``, at the leaf ``param_err_leaf``) it reports
    the same over the elements whose unsharded gradient is at least
    :data:`ADAM_WELL_POSED` x Adam's eps (``param_err_well_posed``):
    below that, Adam's first update lr * g / (|g| + eps) moves by up to
    lr / eps per unit of g, so the gradient's rounding is all that the
    update shows."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    from repro_torch.train.checkpoint import flatten
    p0, o0, m0 = unsharded
    p_init, logits0, dec0 = serve0
    mesh = make_device_mesh(shape, "cpu")
    scale = max(float(t.detach().abs().max()) for _, t in flatten(p0))
    make, sh = S.build_sharded_train_step(cfg, tc, mesh, rules)
    p1 = SH.distribute_tree(T.init_params(0, cfg, device="cpu"),
                            sh["params"], mesh)
    opt = S.make_optimizer(tc, p1)
    m1 = make(batch)(p1, opt, batch)
    param_err, worst, shapes_ok, moments_ok, sharded = 0.0, "", True, True, 0
    posed_err = 0.0
    for ((key, a), (_, b)), (_, ns), mu, mu0 in zip(
            zip(flatten(p0), flatten(p1)), flatten(sh["params"]), opt.mu,
            o0.mu):
        diff = (a.detach() - b.detach().full_tensor()).abs()
        if float(diff.max()) / scale > param_err:
            param_err, worst = float(diff.max()) / scale, key
        posed = mu0.abs() >= (1 - o0.b1) * ADAM_WELL_POSED * o0.eps
        if bool(posed.any()):
            posed_err = max(posed_err, float(diff[posed].max()) / scale)
        want = [n // SH.axis_size(shape, ax)
                for n, ax in zip(a.shape, ns.spec)]
        shapes_ok &= list(b.to_local().shape) == want
        moments_ok &= tuple(mu.placements) == tuple(b.placements)
        sharded += b.to_local().numel() < b.numel()
    make_p, _ = S.build_sharded_prefill(cfg, mesh, max_len, rules)
    p2 = SH.distribute_tree(p_init, sh["params"], mesh)
    logits1, cache1 = make_p(prompts)(p2, prompts)
    serve, _ = S.build_sharded_serve_step(cfg, mesh, rules,
                                          batch=len(decode[0]),
                                          max_len=max_len)
    dec_err = 0.0
    for tok, want in zip(decode, dec0):
        got, cache1 = serve(p2, cache1, tok)
        dec_err = max(dec_err, _rel(got, want))
    return {"loss_rel": abs(float(m1["loss"]) / float(m0["loss"]) - 1),
            "grad_norm_rel": abs(float(m1["grad_norm"])
                                 / float(m0["grad_norm"]) - 1),
            "param_err": param_err, "param_err_leaf": worst,
            "param_err_well_posed": posed_err,
            "shapes_ok": shapes_ok, "moments_ok": moments_ok,
            "sharded_leaves": sharded,
            "prefill_rel": _rel(logits1, logits0), "decode_rel": dec_err}


# the gradients, in units of Adam's eps, from which its first update is
# well posed (its sensitivity to the gradient lr * eps / (|g| + eps)^2 at
# most lr / (10^4 eps))
ADAM_WELL_POSED = 100

# the families the sharded builders run beyond the dense one, reduced, on
# mesh (2, 2): MoE (expert parallel), sliding window (window 16 under a
# 24-token prompt: the ring cache rotates in the prefill and wraps in
# decode), Mamba + attention + MoE, mLSTM/sLSTM, encoder-decoder (frames,
# xk/xv caches), vision prefix (patches)
FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x22b",
                "jamba-1.5-large-398b", "xlstm-1.3b", "whisper-base",
                "internvl2-26b")
FAMILY_MESH = {"data": 2, "model": 2}


def sharded_families(rank: int, world: int, tmp: str, arch: str) -> dict:
    """:func:`_sharded_vs_unsharded` on :data:`FAMILY_MESH` for ``arch``'s
    reduced config in fp32: a train step on 4 x 32 tokens (behind
    patches, beside frames, drawn from a seed), a prefill of 4 x 24
    tokens and 3 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.train import steps as S
    cfg = _fp32(get_config(arch, reduced=True))
    tc = S.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(2)

    def inputs(seq, labels):
        out = {"tokens": torch.randint(0, cfg.vocab, (4, seq),
                                       generator=gen)}
        if labels:
            out["labels"] = torch.randint(0, cfg.vocab, (4, seq),
                                          generator=gen)
        for key, n in (("patches", cfg.vision_prefix),
                       ("frames", cfg.enc_seq if cfg.enc_dec else 0)):
            if n:
                out[key] = torch.randn((4, n, cfg.d_model), generator=gen)
        return out

    batch, prompts = inputs(32, True), inputs(24, False)
    decode = [torch.randint(0, cfg.vocab, (4, 1), generator=gen)
              for _ in range(3)]
    max_len = cfg.vision_prefix + 40
    return _sharded_vs_unsharded(
        cfg, tc, FAMILY_MESH, SH.ShardingRules(), batch, prompts, decode,
        max_len, _unsharded_train(cfg, tc, batch),
        _unsharded_serve(cfg, prompts, decode, max_len))


def compression(rank: int, world: int, tmp: str, inputs: str) -> dict:
    """``compressed_psum_mean`` on this rank's slice of the seeded inputs
    (``inputs``: an npz of (world, ...) gradients ``g_<k>`` and errors
    ``e_<k>``), then the reference's toy quadratic: 150 steps of
    ``make_ddp_compressed_step`` over a (world, 1) mesh."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.optim import compression as C
    from repro_torch.optim.adam import Adam
    data = np.load(inputs)
    keys = sorted(k[2:] for k in data.files if k.startswith("g_"))
    grads = {k: torch.from_numpy(data["g_" + k][rank:rank + 1])
             for k in keys}
    err = {k: torch.from_numpy(data["e_" + k][rank:rank + 1]) for k in keys}
    synced, new_err = C.compressed_psum_mean(grads, err)

    mesh = make_device_mesh({"data": world, "model": 1}, "cpu")
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.normal(size=(8, 1)).astype(np.float32))
    params = {"w": torch.zeros((8, 1), requires_grad=True)}
    opt = Adam([params["w"]], lr=3e-2)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    step = C.make_ddp_compressed_step(loss_fn, opt, mesh)
    e = C.init_error_state(params)
    losses = []
    for _ in range(150):
        x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
        e, loss = step(params, opt, e, {"x": x, "y": x @ w_true})
        losses.append(float(loss))
    return {"synced": {k: v.numpy() for k, v in synced.items()},
            "err": {k: v.numpy() for k, v in new_err.items()},
            "losses": losses}


def mesh_trainer(rank: int, world: int, tmp: str) -> dict:
    """The reference's two trainer tests' setups on a (world, 1) mesh:
    reduced smollm-360m with a crash at 17 and a NaN batch at 26 over 40
    steps; reduced qwen2-1.5b trained 10 steps, then a new Trainer on the
    same directory resumed and run to 16."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.train.steps import TrainConfig
    from repro_torch.train.trainer import (FailureInjector, Trainer,
                                           TrainerConfig)
    mesh = make_device_mesh({"data": world, "model": 1}, "cpu")
    out = {}
    cfg = get_config("smollm-360m", reduced=True)
    injector = FailureInjector(crash_at=17, nan_at=26)
    tr = Trainer(cfg, TrainConfig(lr=1e-3, warmup_steps=5, total_steps=60),
                 TrainerConfig(steps=40, ckpt_dir=os.path.join(tmp, "faults"),
                               ckpt_every=10, log_every=5),
                 data_cfg=DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=4, structure=16),
                 injector=injector, mesh=mesh)
    out["faults"] = {"log": tr.run(), "step": tr.step,
                     "fired": injector.fired}

    cfg = get_config("qwen2-1.5b", reduced=True)
    tc = TrainConfig(lr=5e-4, warmup_steps=2, total_steps=30)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, structure=8)
    ck = os.path.join(tmp, "restart")
    first = Trainer(cfg, tc, TrainerConfig(steps=10, ckpt_dir=ck,
                                           ckpt_every=5),
                    data_cfg=dc, mesh=mesh)
    first.run()
    second = Trainer(cfg, tc, TrainerConfig(steps=16, ckpt_dir=ck,
                                            ckpt_every=5),
                     data_cfg=dc, mesh=mesh)
    resumed = {"step": second.step, "opt_step": second.opt.step_count,
               "equal": all(torch.equal(a.detach().to_local(),
                                        b.detach().to_local())
                            for a, b in zip(
                                second.opt.params + second.opt.mu
                                + second.opt.nu,
                                first.opt.params + first.opt.mu
                                + first.opt.nu))}
    second.run()
    out["restart"] = dict(resumed, final_step=second.step)
    return out


def elastic_restore(rank: int, world: int, tmp: str, ckpt: str,
                    out_dir: str) -> dict:
    """The reference's reduced qwen2-1.5b checkpoint under ``ckpt``
    (written on one device, its layers stacked) restored onto a (2, 2)
    mesh at the port's placements (a stacked leaf takes its layer's spec
    behind the stack's unsharded dim); then the restored DTensors saved
    under ``out_dir`` by the port (gathered, rank 0 writes)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as CKPT
    shape = {"data": 2, "model": 2}
    mesh = make_device_mesh(shape, "cpu")
    cfg = get_config("qwen2-1.5b", reduced=True)
    port_sh = SH.param_shardings(T.abstract_params(cfg), shape, cfg)
    _, flat, _ = CKPT.restore(ckpt)
    target, shardings = {}, {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "layers":   # layers/<period pos>/<part>/<leaf>
            spec = (None,) + port_sh["layers"][int(parts[1])][
                parts[2]][parts[3]].spec
            sh = SH.NamedSharding(shape, spec)
        else:
            sh = port_sh[parts[0]]
        node, snode = target, shardings
        for part in parts[:-1]:
            node, snode = node.setdefault(part, {}), snode.setdefault(part,
                                                                      {})
        node[parts[-1]] = torch.empty(arr.shape, dtype=arr.dtype,
                                      device="meta")
        snode[parts[-1]] = sh
    step, tree, _ = CKPT.restore(ckpt, target=target, shardings=shardings,
                                 device_mesh=mesh)
    leaves = CKPT.flatten(tree)
    equal = all(torch.equal(t.full_tensor(), flat[k]) for k, t in leaves)
    shards = max(t.numel() // t.to_local().numel() for _, t in leaves)
    CKPT.save(out_dir, step, tree)
    return {"step": step, "equal": equal, "max_shards": shards,
            "placements": {k: str(tuple(t.placements)) for k, t in leaves}}


JOBS = {"sharded_steps": sharded_steps, "compression": compression,
        "mesh_trainer": mesh_trainer, "elastic_restore": elastic_restore,
        "sharded_families": sharded_families}
