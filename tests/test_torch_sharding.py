"""Port parity for the placement rules (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``) against ``repro.dist.sharding``.

A placement is held as decisions: the axis names each dim of each leaf
gets, where a bare name and a 1-tuple are one decision (jax 0.9 stores the
spec entry ``("data",)`` as ``'data'``).  The reference's mesh is a
``jax.sharding.AbstractMesh`` of the same shape, so no placeholder devices
are needed.  Param leaves: the reference's layer stacks carry a leading
repeats dim that is never sharded, so the port's layer ``i`` leaf is held
against period position ``i % period`` of the reference's stack without
that dim.  Cache leaves: the reference's recurrent entries nest the state
under ``ssm``/``lstm``/``slstm``; the port's entry holds the state's
fields.  Exact equality throughout (decisions and byte counts).

The reference's three red placement tests (``test_fsdp_rules_shard_
remaining_dim``, ``test_batch_specs_and_batch_sharding``,
``test_cache_shardings_batch_and_kv_dims``) fail on that representation
only; their rules are held here as decisions.  Its two red step tests
(the sharded train step) are the multi-process step builders' ground."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

from _torch_support import one_torch_thread  # noqa: F401
from repro.configs import ARCH_NAMES, get_config as jget
from repro.dist import sharding as JSH
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT

MESHES = {"1x1": M.make_host_mesh(1, 1), "2x4": M.make_host_mesh(2, 4),
          "16x16": M.make_production_mesh(),
          "2x16x16": M.make_production_mesh(multi_pod=True)}
RULES = {"default": dict(), "fsdp": dict(fsdp_weights=True),
         "sp": dict(sequence_parallel=True)}
_STATE_GROUP = {"mamba": "ssm", "mlstm": "lstm", "slstm": "slstm"}


def _abstract(mesh):
    return AbstractMesh(tuple(mesh.values()), tuple(mesh.keys()))


def _decision(axes):
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _decisions(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [_decision(a) for a in spec]


def _ref_table(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))[0]
    return {JSH._path_names(p): s for p, s in flat}


def test_mesh_shapes_match_reference_fallback():
    """``make_dryrun_mesh(n)`` is the reference's proportional fallback
    (``src/repro/launch/mesh.py``) with the device count passed in."""
    def ref(n, multi_pod):        # the reference's arithmetic, verbatim
        if n >= 512 or (not multi_pod and n >= 256):
            return ({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
        if multi_pod:
            per_pod = n // 2
            model = max(1, int(per_pod ** 0.5))
            while per_pod % model:
                model -= 1
            return {"pod": 2, "data": per_pod // model, "model": model}
        model = max(1, int(n ** 0.5))
        while n % model:
            model -= 1
        return {"data": n // model, "model": model}
    for n in (1, 2, 4, 6, 8, 12, 16, 64, 100, 256, 512, 1024):
        for mp in (False, True):
            got = M.make_dryrun_mesh(n, multi_pod=mp)
            assert got == ref(n, mp) and list(got) == list(ref(n, mp))
    assert M.describe(M.make_host_mesh(2, 4, pod=2)) == \
        "pod=2 x data=2 x model=4"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_recommended_rules_match_reference(arch):
    for reduced in (False, True):
        j = JSH.ShardingRules.recommended(jget(arch, reduced=reduced))
        t = SH.ShardingRules.recommended(tget(arch, reduced=reduced))
        assert (t.fsdp_weights, t.sequence_parallel, t.tp_axis,
                t.fsdp_min_size) == (j.fsdp_weights, j.sequence_parallel,
                                     j.tp_axis, j.fsdp_min_size)
        assert t.describe() == j.describe()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axis_arithmetic_matches_reference(mesh_name):
    mesh = MESHES[mesh_name]
    am = _abstract(mesh)
    assert SH.data_axes(mesh) == JSH.data_axes(am)
    for axes in (None, "model", "data", "pod", ("pod", "data"),
                 ("data", "model"), ("pod", "data", "model")):
        assert SH.axis_size(mesh, axes) == JSH.axis_size(am, axes)
        for n in (1, 2, 3, 6, 8, 15, 16, 32, 48, 512):
            assert SH.fit_axes(n, axes, mesh) == JSH.fit_axes(n, axes, am)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_placements_match_reference(arch, reduced):
    """Every param leaf on every mesh under every rule set: the same
    decisions per dim, and the same bytes a device."""
    jc, tc = jget(arch, reduced=reduced), tget(arch, reduced=reduced)
    jab = JT.abstract_params(jax.random.PRNGKey(0), jc)
    tab = TT.abstract_params(tc)
    for mesh in MESHES.values():
        am = _abstract(mesh)
        for kw in RULES.values():
            js = _ref_table(JSH.param_shardings(jab, am, jc,
                                                JSH.ShardingRules(**kw)))
            ts = SH.param_shardings(tab, mesh, tc, SH.ShardingRules(**kw))
            seen = set()
            for path, s in SH._leaves_with_path(ts):
                names = SH._path_names(path)
                if names[0] in ("layers", "enc_layers"):
                    period = len(jc.pattern) if names[0] == "layers" else 1
                    key = (names[0], str(int(names[1]) % period)) + names[2:]
                    full = _decisions(js[key].spec, len(s.spec) + 1)
                    assert full[0] is None, key     # the stack dim
                    want = full[1:]
                else:
                    key = names
                    want = _decisions(js[key].spec, len(s.spec))
                seen.add(key)
                assert _decisions(s.spec, len(s.spec)) == want, (key, mesh,
                                                                 kw)
            assert seen == set(js)
            SH.validate_shardings(tab, ts)
            assert SH.param_bytes_per_device(tab, ts) == \
                JSH.param_bytes_per_device(jab, JSH.param_shardings(
                    jab, am, jc, JSH.ShardingRules(**kw)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_placements_match_reference(arch):
    """Each batch leaf (tokens, labels, patches, frames) at batches that
    do and do not divide the data axes; the decode token's placement."""
    jc, tc = jget(arch, reduced=True), tget(arch, reduced=True)
    for mesh in MESHES.values():
        am = _abstract(mesh)
        for b in (1, 6, 8, 32):
            shapes = {"tokens": (b, 16), "labels": (b, 16)}
            if jc.vision_prefix:
                shapes["patches"] = (b, jc.vision_prefix, jc.d_model)
            if jc.enc_dec:
                shapes["frames"] = (b, jc.enc_seq, jc.d_model)
            jb = {k: jax.ShapeDtypeStruct(s, np.float32)
                  for k, s in shapes.items()}
            tb = {k: torch.empty(s, device="meta")
                  for k, s in shapes.items()}
            js, ts = JSH.batch_specs(jb, am), SH.batch_specs(tb, mesh)
            for k, s in shapes.items():
                assert _decisions(ts[k].spec, len(s)) == \
                    _decisions(js[k].spec, len(s)), (k, b, mesh)
            assert _decisions(SH.batch_sharding(mesh, b, 1).spec, 1) == \
                _decisions(JSH.batch_sharding(am, b, 1).spec, 1)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_placements_match_reference(arch):
    jc, tc = jget(arch, reduced=True), tget(arch, reduced=True)
    for b in (2, 8):
        jcache = jax.eval_shape(lambda: JT.init_cache(jc, b, 32))
        tcache = TT.init_cache(tc, b, 32, device="meta")
        kinds = tc.layer_kinds()
        for mesh in MESHES.values():
            am = _abstract(mesh)
            for kw in RULES.values():
                js = _ref_table(JSH.cache_shardings(
                    jcache, am, jc, JSH.ShardingRules(**kw)))
                ts = SH.cache_shardings(tcache, mesh, tc,
                                        SH.ShardingRules(**kw))
                for path, s in SH._leaves_with_path(ts):
                    names = SH._path_names(path)
                    if names[0] == "pos":
                        assert _decisions(s.spec, 1) == \
                            _decisions(js[("pos",)].spec, 1)
                        continue
                    i, leaf = int(names[1]), names[-1]
                    mixer = kinds[i][0]
                    key = ("layers", str(i % len(jc.pattern)))
                    if mixer in _STATE_GROUP and leaf not in ("xk", "xv"):
                        key += (_STATE_GROUP[mixer],)
                    key += (leaf,)
                    want = _decisions(js[key].spec, len(s.spec) + 1)
                    assert want[0] is None, key     # the stack dim
                    assert _decisions(s.spec, len(s.spec)) == want[1:], \
                        (key, mesh, kw)
                SH.validate_shardings(tcache, ts)


# ------------------------------------------ the reference's red tests' rules

def test_fsdp_rule_shards_remaining_dim_over_data():
    """``test_fsdp_rules_shard_remaining_dim``'s rule: full smollm, FSDP
    on a 1x1 mesh: wq's output dim on the model axis (TP), its input dim
    on the data axes (ZeRO-3)."""
    mesh = M.make_host_mesh(1, 1)
    cfg = tget("smollm-360m")
    ab = TT.abstract_params(cfg)
    sh = SH.param_shardings(ab, mesh, cfg,
                            SH.ShardingRules(fsdp_weights=True))
    wq = sh["layers"][0]["mix"]["wq"].spec
    assert _decision(wq[-1]) == ("model",) and _decision(wq[0]) == ("data",)
    SH.validate_shardings(ab, sh)


def test_batch_rule_shards_dim0_over_data():
    """``test_batch_specs_and_batch_sharding``'s rule: every batch leaf's
    dim 0 on the data axes, the rest unsharded; a token array the same."""
    mesh = M.make_host_mesh(1, 1)
    batch = {"tokens": torch.empty((4, 16), dtype=torch.int32,
                                   device="meta"),
             "labels": torch.empty((4, 16), dtype=torch.int32,
                                   device="meta"),
             "patches": torch.empty((4, 8, 32), dtype=torch.bfloat16,
                                    device="meta")}
    sh = SH.batch_specs(batch, mesh)
    for k, s in sh.items():
        assert isinstance(s, SH.NamedSharding), k
        assert _decision(s.spec[0]) == ("data",), k
        assert all(a is None for a in s.spec[1:]), k
    assert _decision(SH.batch_sharding(mesh, 4, 1).spec[0]) == ("data",)


def test_cache_rule_shards_batch_and_kv_heads():
    """``test_cache_shardings_batch_and_kv_dims``'s rule: ``pos`` and each
    KV entry's batch dim on the data axes, the kv-head dim on the model
    axis, the cache's sequence never."""
    mesh = M.make_host_mesh(1, 1)
    cfg = tget("qwen2-1.5b", reduced=True)
    cache = TT.init_cache(cfg, 2, 32, device="meta")
    sh = SH.cache_shardings(cache, mesh, cfg)
    assert _decision(sh["pos"].spec[0]) == ("data",)
    k = sh["layers"][0]["k"].spec
    assert _decision(k[0]) == ("data",)
    assert _decision(k[2]) == ("model",)
    assert k[1] is None
    SH.validate_shardings(cache, sh)


def test_validate_rejects_and_describe_lists():
    mesh = M.make_host_mesh(2, 4)
    cfg = tget("qwen2-1.5b", reduced=True)
    ab = TT.abstract_params(cfg)
    sh = SH.param_shardings(ab, mesh, cfg)
    bad = dict(sh, final_ln=SH.NamedSharding(mesh, ("model",)))
    bad_ab = dict(ab, final_ln=torch.empty((6,), device="meta"))
    with pytest.raises(ValueError, match="final_ln"):
        SH.validate_shardings(bad_ab, bad)
    with pytest.raises(ValueError, match="tree mismatch"):
        SH.validate_shardings(ab, {"embed": sh["embed"]})
    table = SH.describe_shardings(ab, sh, max_rows=3)
    assert table.splitlines()[0].startswith("embed")
    assert "more)" in table.splitlines()[-1]
