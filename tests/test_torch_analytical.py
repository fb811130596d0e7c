"""Port parity: the analytical TPU model over the full knob grid of every
ResNet-18 conv task, against the reference's jnp functions."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.core.task import conv_tasks as jax_conv_tasks
from repro.hw import analytical as JA
from repro_torch.hw import analytical as TA

TASKS = jax_conv_tasks("resnet-18", batch=1)
# at batch 8 the largest tiles overflow the 128 MiB VMEM: the sentinel path
BATCH8 = [t for t in jax_conv_tasks("resnet-18", batch=8)
          if t.name == "resnet-18:conv2a"]
INF32 = np.float32(JA._INF)  # the sentinel as both packages store it


def _grid_values(space):
    grids = np.meshgrid(*[np.asarray(c, np.float32) for c in space.choices],
                        indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def test_resnet18_has_eight_unique_tasks():
    assert len(TASKS) == 8
    assert sum(t.multiplicity for t in TASKS) == 17


@pytest.mark.parametrize(
    "task", TASKS + BATCH8,
    ids=[t.name for t in TASKS] + [t.name + "@b8" for t in BATCH8])
def test_conv2d_latency_full_grid(task):
    wl = task.space.workload
    v = _grid_values(task.space)
    assert 6000 <= len(v) <= 70000
    cols = [v[:, i] for i in (0, 5, 6, 1, 2, 3, 4)]
    j_lat, j_vmem = JA.conv2d_latency(wl, *[jnp.asarray(c) for c in cols])
    t_lat, t_vmem = TA.conv2d_latency(wl, *[torch.from_numpy(c) for c in cols])
    j_lat, t_lat = np.asarray(j_lat), t_lat.numpy()
    np.testing.assert_array_equal(j_lat == INF32, t_lat == INF32)
    np.testing.assert_allclose(t_lat, j_lat, rtol=1e-6)
    np.testing.assert_allclose(t_vmem.numpy(), np.asarray(j_vmem), rtol=1e-6)
    if wl["b"] == 8:
        assert 0 < (t_lat == INF32).sum() < len(t_lat)


def test_gemm_latency_grid_and_infeasible_mask():
    rng = np.random.default_rng(0)
    pow2 = lambda hi, n: (2.0 ** rng.integers(0, hi, n)).astype(np.float32)
    n = 4096
    n_inf = n_ok = 0
    args = [pow2(12, n), pow2(10, n), pow2(13, n),
            rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
            rng.choice([1.0, 2.0, 4.0], n).astype(np.float32)]
    for m, nn, k in [(512, 512, 512), (100352, 64, 147), (7, 3000, 33),
                      (8192, 4096, 8192)]:
        j_lat, j_vmem = JA.gemm_latency(m, nn, k,
                                        *[jnp.asarray(a) for a in args])
        t_lat, t_vmem = TA.gemm_latency(m, nn, k,
                                        *[torch.from_numpy(a) for a in args])
        np.testing.assert_array_equal(np.asarray(j_lat) == INF32,
                                      t_lat.numpy() == INF32)
        n_inf += int((t_lat.numpy() == INF32).sum())
        n_ok += int((t_lat.numpy() < 1).sum())
        np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat),
                                   rtol=1e-6)
        np.testing.assert_allclose(t_vmem.numpy(), np.asarray(j_vmem),
                                   rtol=1e-6)
    # the sweep must reach both sides of the VMEM feasibility edge
    assert n_inf > 0 and n_ok > 0


def test_python_int_arguments_and_scalar_helpers():
    wl = TASKS[3].space.workload
    j_lat, _ = JA.conv2d_latency(wl, 1, 4, 4, 32, 64, 2, 2)
    t_lat, _ = TA.conv2d_latency(wl, 1, 4, 4, 32, 64, 2, 2)
    np.testing.assert_allclose(float(t_lat), float(j_lat), rtol=1e-6)
    for t in TASKS:
        wl = t.space.workload
        dims = [wl[k] for k in ("b", "h", "w", "ci", "co", "kh", "kw",
                                "stride", "pad")]
        assert TA.conv2d_im2col_dims(*dims) == JA.conv2d_im2col_dims(*dims)
        assert TA.conv2d_min_latency(wl) == JA.conv2d_min_latency(wl)
        assert TA.conv2d_gflops(wl, 1e-4) == JA.conv2d_gflops(wl, 1e-4)
