"""The port on the card: the Hopper GEMM kernel against its plain version,
and the tune -> deploy path on CUDA tensors.  Every test here carries the
``gpu`` marker and skips where torch sees no CUDA device.  This file
imports neither jax nor the reference package, so it also runs on a GPU
machine that has only the port's dependencies:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from _torch_support import require_cuda
from repro_torch.kernels import gemm as TG
from repro_torch.kernels import ops

SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
          (257, 129, 65), (392, 4608, 512), (6272, 576, 128)]
CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
           (16, 64, 128, False, True), (8, 128, 256, True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
def test_kernel_matches_plain_on_card(dtype, tol):
    """Every launch counts once; the kernel agrees with its plain version
    to ``tol`` x max |plain| (two fp32 sums in different orders; in bf16
    both round the fp32 sum once)."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES:
        for cfg in CONFIGS:
            a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
            launches = TG.gemm.launches
            got = TG.gemm(a, b, TG.GemmConfig(*cfg))
            assert TG.gemm.launches == launches + 1
            assert got.dtype == dtype and got.shape == (m, n)
            want = TG.gemm(a, b, TG.GemmConfig(*cfg), use_kernel=False)
            assert TG.gemm.launches == launches + 1
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max()
            assert float(err) <= tol * float(want.float().abs().max())


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    require_cuda()
    a = torch.ones(64, 32, device="cuda")
    with pytest.raises(ValueError):
        TG.gemm(a.t(), a)  # non-contiguous
    with pytest.raises(ValueError):
        TG.gemm(a, torch.ones(32, 8))  # operands on two devices


@pytest.mark.gpu
def test_tune_then_deploy_on_card():
    """Two ResNet-18 tasks tuned on the card; their geometries deploy in a
    conv through the kernel, within 1e-4 of cuDNN fp32."""
    require_cuda()
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ref
    tasks = TuningTask.conv_tasks("resnet-18", batch=2)[:2]
    rep = Session(tasks, tuner=TunerConfig.fast(), budget=24).run()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for task in tasks:
        wl, k = task.space.workload, rep[task.name].best_settings
        x = torch.randn((2, 32, 32, wl["ci"]), generator=gen, device="cuda")
        w = torch.randn((wl["kh"], wl["kw"], wl["ci"], wl["co"]),
                        generator=gen, device="cuda")
        launches = TG.gemm.launches
        out = ops.conv2d_from_knobs(
            x, w, wl["stride"], wl["pad"], tile_b=k["tile_b"],
            tile_h=k["tile_h"], tile_w=k["tile_w"], tile_ci=k["tile_ci"],
            tile_co=k["tile_co"], h_threading=k["h_threading"],
            oc_threading=k["oc_threading"])
        assert TG.gemm.launches == launches + 1
        want = ref.conv2d_ref(x, w, wl["stride"], wl["pad"])
        torch.cuda.synchronize()
        err = (out - want).abs().max()
        assert float(err) <= 1e-4 * float(want.abs().max())
