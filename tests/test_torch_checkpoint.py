"""The port's checkpoints against the reference's format: the reference's
four checkpoint tests on the port, the stdlib msgpack subset byte for byte
against ``msgpack.packb``, checkpoints read across the packages in both
directions and with both codecs, bf16 leaves, the async writer's copy,
and the zstd-without-zstandard error."""
import os

import msgpack
import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from _torch_dist import run_ranks
from _torch_support import one_torch_thread  # noqa: F401
from repro.train import checkpoint as JCKPT
from repro_torch.train import checkpoint as CKPT


# ------------------------------------------ the reference's tests, ported

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    CKPT.save(str(tmp_path), 5, tree, {"note": "x"})
    target = {"a": torch.zeros(3, 4),
              "b": {"c": torch.zeros(3, dtype=torch.int32)}}
    step, out, meta = CKPT.restore(str(tmp_path), target=target)
    assert step == 5 and meta["note"] == "x"
    assert out is target
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.ones(4)}
    d = CKPT.save(str(tmp_path), 1, tree)
    f = os.path.join(d, "data.msgpack.zst")
    blob = bytearray(open(f, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(f, "wb").write(bytes(blob))
    with pytest.raises(Exception):
        CKPT.restore(str(tmp_path), target={"a": torch.zeros(4)})


def test_checkpoint_manager_keep_k(tmp_path):
    mgr = CKPT.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(s, {"x": torch.tensor([s])})
    assert CKPT.available_steps(str(tmp_path)) == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async(tmp_path):
    mgr = CKPT.CheckpointManager(str(tmp_path), keep=3)
    mgr.save_async(7, {"x": torch.ones(128, 128)})
    mgr.wait()
    assert mgr.latest_step() == 7


# --------------------------------------------------------------- msgpack

MSGPACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, 1.5, -2.25e-300, float("inf"),
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, "x" * 70000,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), (1, "two", 3.0), {},
    {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {f"k{i}": [i, str(i)] for i in range(70000)},
    {"step": 40, "meta": {"data_step": 40}, "codec": "zlib",
     "leaves": {"params/embed": {"shape": [512, 64], "dtype": "bfloat16",
                                 "crc": 3735928559},
                "opt/step": {"shape": [], "dtype": "int32", "crc": 7}}},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES,
                         ids=[f"case{i}" for i in range(len(MSGPACK_CASES))])
def test_msgpack_subset_is_byte_identical(obj):
    want = msgpack.packb(obj)
    assert CKPT.packb(obj) == want
    back = CKPT.unpackb(want)
    assert back == msgpack.unpackb(want)


def test_msgpack_subset_refuses_what_it_does_not_write():
    with pytest.raises(TypeError):
        CKPT.packb({"x": np.int64(3)})
    with pytest.raises(OverflowError):
        CKPT.packb(2 ** 64)
    with pytest.raises(ValueError):
        CKPT.unpackb(msgpack.packb(1) + b"\x00")


# ------------------------------------------------------- across packages

def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"layers": [{"w": rng.standard_normal((3, 4)).astype(
        np.float32)} for _ in range(11)],
        "embed": rng.standard_normal((5, 2)).astype(np.float32)},
        "opt": {"step": np.asarray(7, np.int32)}}


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_reads_the_ports_checkpoint(tmp_path, monkeypatch, codec):
    monkeypatch.setattr(CKPT, "DEFAULT_CODEC", codec)
    tree = _tree()
    CKPT.save(str(tmp_path), 3, CKPT.tree_map(torch.from_numpy, tree),
              {"data_step": 3})
    step, arrays, meta = JCKPT.restore(str(tmp_path), target=None)
    assert step == 3 and meta == {"data_step": 3}
    flat = dict(CKPT.flatten(tree))
    assert list(arrays) == [k for k, _ in CKPT.flatten(tree)]
    assert "params/layers/10/w" in arrays
    for key, want in flat.items():
        assert arrays[key].dtype == want.dtype
        np.testing.assert_array_equal(arrays[key], want)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_port_reads_the_references_checkpoint(tmp_path, monkeypatch, codec):
    """The reference writes (its codec set by monkeypatching its module
    global; its code is not edited), the port restores flat and into a
    target tree."""
    monkeypatch.setattr(JCKPT, "DEFAULT_CODEC", codec)
    tree = _tree()
    JCKPT.save(str(tmp_path), 9, jax.tree.map(jnp.asarray, tree),
               {"data_step": 9})
    with open(os.path.join(tmp_path, "step_00000009",
                           "manifest.msgpack"), "rb") as f:
        assert CKPT.unpackb(f.read())["codec"] == codec
    step, arrays, meta = CKPT.restore(str(tmp_path))
    assert step == 9 and meta == {"data_step": 9}
    for key, want in CKPT.flatten(tree):
        np.testing.assert_array_equal(arrays[key].numpy(), want)
    target = CKPT.tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float64)
                           if a.dtype == np.float32 else
                           torch.zeros(a.shape, dtype=torch.int32), tree)
    CKPT.restore(str(tmp_path), target=target)
    np.testing.assert_array_equal(target["params"]["layers"][4]["w"].numpy(),
                                  tree["params"]["layers"][4]["w"])
    assert target["params"]["embed"].dtype == torch.float64


def test_bf16_leaves_roundtrip_and_read_by_the_reference(tmp_path):
    """A bf16 leaf is its raw 2-byte words under "bfloat16": the port reads
    it back bit for bit, the reference reads it as ml_dtypes' bfloat16."""
    x = torch.randn(7, 3, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    CKPT.save(str(tmp_path), 1, {"x": x, "y": x[0].float()})
    _, arrays, _ = CKPT.restore(str(tmp_path))
    assert arrays["x"].dtype == torch.bfloat16
    assert torch.equal(arrays["x"].view(torch.int16), x.view(torch.int16))
    _, jarrays, _ = JCKPT.restore(str(tmp_path), target=None)
    assert jarrays["x"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jarrays["x"].astype(np.float32),
                                  x.float().numpy())
    target = {"x": torch.zeros(7, 3, dtype=torch.bfloat16),
              "y": torch.zeros(3)}
    CKPT.restore(str(tmp_path), target=target)
    assert torch.equal(target["x"], x)


def test_async_snapshot_is_a_copy(tmp_path):
    """``save_async`` copies CPU tensors before it returns: an in-place
    update right after (as the optimizer makes) does not reach the file."""
    x = torch.zeros(256, 256)
    mgr = CKPT.CheckpointManager(str(tmp_path), keep=3)
    mgr.save_async(2, {"x": x, "nested": [x]})
    x.add_(1.0)
    mgr.wait()
    _, arrays, _ = CKPT.restore(str(tmp_path))
    assert float(arrays["x"].abs().max()) == 0.0
    assert float(arrays["nested/0"].abs().max()) == 0.0


def test_zstd_checkpoint_without_zstandard_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(CKPT, "DEFAULT_CODEC", "zstd")
    if CKPT.zstd is None:
        pytest.skip("zstandard is not installed: no zstd checkpoint to write")
    CKPT.save(str(tmp_path), 1, {"x": torch.ones(3)})
    monkeypatch.setattr(CKPT, "zstd", None)
    with pytest.raises(ImportError, match="zstandard"):
        CKPT.restore(str(tmp_path))


# ---------------------------------------------- elastic restore on a mesh

@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The reference's reduced qwen2-1.5b params saved by the reference on
    one device, restored by the port onto a (2, 2) mesh of 4 gloo ranks
    and saved from there by the port (the reference's
    ``test_elastic_restore_across_meshes``, across the packages)."""
    from repro.configs import get_config
    from repro.models import transformer as JT
    tmp = tmp_path_factory.mktemp("elastic")
    ref_dir, port_dir = str(tmp / "ref"), str(tmp / "port")
    params = JT.init_params(jax.random.PRNGKey(0),
                            get_config("qwen2-1.5b", reduced=True))
    JCKPT.save(ref_dir, 3, params)
    ranks = run_ranks("elastic_restore", 4, tmp / "ranks", timeout=240,
                      ckpt=ref_dir, out_dir=port_dir)
    return ref_dir, port_dir, ranks


def test_reference_checkpoint_restores_onto_a_mesh(elastic):
    _, _, ranks = elastic
    for got in ranks:
        assert got["step"] == 3 and got["equal"]
        assert got["max_shards"] > 1          # actually distributed
    assert "Shard(dim=0)" in ranks[0]["placements"]["embed"]


def test_mesh_checkpoint_restores_on_one_device(elastic):
    ref_dir, port_dir, _ = elastic
    _, want, _ = JCKPT.restore(ref_dir)
    step, got, _ = CKPT.restore(port_dir)
    assert step == 3 and set(got) == set(want)
    for key, arr in want.items():     # bf16 leaves: bit for bit
        assert got[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(
            got[key].view(torch.int16).numpy(),
            np.asarray(arr).view(np.int16), err_msg=key)
