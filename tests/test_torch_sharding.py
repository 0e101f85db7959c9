"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's ``repro.distributed.sharding``.

Both rule sets read only a mesh's axis names and extents, so one stub mesh
(``axis_names`` and an ``np.empty((data, model))`` of devices) serves both
packages without 8 JAX devices, on each of the six meshes (1,1), (2,1),
(1,2), (2,2), (4,2), (2,4).  Specs are compared as tuples (a
``PartitionSpec`` is one).  States and parameter trees are made at the
reference's reduced dit-b2 (``dit-smoke``) and at DiT-XL/2's full shapes;
the full-size trees are shapes only (the port's on the ``meta`` device,
the reference's through ``jax.eval_shape``).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.distributed import sharding as jsh
from repro.models import build_model
from repro.obs import metrics as jmetrics
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import registered_policies
from repro_torch.core.runner import CachedDiT
from repro_torch.distributed import sharding as sh
from repro_torch.models.dit import DiTModel
from repro_torch.obs import metrics as tmetrics
from tests.test_torch_slo import _port_leaves

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4))
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
SLOTS = 4


class StubMesh:
    """What both packages' rules read of a mesh: axis names and a devices
    array of the mesh's shape."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.devices = np.empty((data, model), dtype=object)


def _ctxs(mesh, kind="serve", **flags):
    m = StubMesh(*mesh)
    return (sh.ShardingCtx(m, sh.make_rules(kind, **flags)),
            jsh.ShardingCtx(m, jsh.make_rules(kind, **flags)))


def _tup(spec):
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                 for a in spec)


def _jax_paths(tree, is_leaf=None):
    """{path: leaf} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", None)))
                     for p in path): leaf for path, leaf in flat}


def _jax_specs(tree):
    """{path: spec tuple} of a reference spec tree."""
    return {k: _tup(v) for k, v in _jax_paths(
        tree, lambda x: isinstance(x, jax.sharding.PartitionSpec)).items()}


def _port_specs(tree, prefix=()):
    """{path: spec} of a port spec tree (dicts of tuples, named tuples of
    specs for the gate trackers)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_specs(v, prefix + (str(k),)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_port_specs(getattr(tree, f), prefix + (f,)))
    else:
        out["/".join(prefix)] = _tup(tree)
    return out


# ---------------------------------------------------------------------------
# rule tables and spec_for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "serve", "decode", "prefill"])
@pytest.mark.parametrize("flags", [{}, {"long_context": True},
                                   {"seq_shard": True},
                                   {"attn_seq_shard": True},
                                   {"long_context": True, "seq_shard": True}],
                         ids=["plain", "long", "seq", "attn_seq", "long_seq"])
def test_make_rules_match(kind, flags):
    assert sh.make_rules(kind, **flags) == jsh.make_rules(kind, **flags)


SPEC_CASES = [
    ((1152, 18, 64), ("embed", "heads", "head_dim")),
    ((18, 64, 1152), ("heads", "head_dim", "embed")),
    ((1152, 4608), ("embed", "ffn")),
    ((4608,), ("ffn",)),
    ((4608, 1152), ("ffn", "embed")),
    ((128, 4, 32), ("embed", "heads", "head_dim")),
    ((504,), ("vocab",)),
    ((8, 16, 128), ("act_batch", "act_seq", "act_embed")),
    ((4, 6), ("slot", None)),
    ((3, 6), ("slot", None)),
    ((64, 64), ("embed", "embed")),
    ((8, 8), ("expert", "ffn")),
    ((16, 1024), ("act_batch", "act_kv_seq")),
]


@pytest.mark.parametrize("kind", ["train", "serve", "decode"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spec_for_matches(mesh, kind):
    for flags in ({}, {"long_context": True}):
        ctx, jctx = _ctxs(mesh, kind, **flags)
        for shape, axes in SPEC_CASES:
            assert sh.spec_for(shape, axes, ctx) == \
                _tup(jsh.spec_for(shape, axes, jctx)), (shape, axes, flags)


def test_spec_for_without_ctx_and_rank_mismatch():
    assert sh.spec_for((4, 5), ("slot", None)) == (None, None)
    ctx, _ = _ctxs((2, 1))
    with pytest.raises(ValueError, match="names 1"):
        sh.spec_for((4, 5), ("slot",), ctx)


def test_dit_xl2_heads_on_a_four_way_model_axis():
    """18 heads do not divide 4: the attention weights replicate, the ffn
    shards (the reference's own answer)."""
    ctx, jctx = _ctxs((2, 4))
    assert sh.spec_for((1152, 18, 64), ("embed", "heads", "head_dim"),
                       ctx) == (None, None, None)
    assert sh.spec_for((1152, 4608), ("embed", "ffn"), ctx) == \
        (None, "model")
    assert _tup(jsh.spec_for((1152, 4608), ("embed", "ffn"), jctx)) == \
        (None, "model")


def test_constrain_is_the_identity_with_a_rank_check():
    x = torch.ones((4, 16, 8))
    assert sh.constrain(x, "act_batch", "act_seq", "act_embed") is x
    ctx, _ = _ctxs((2, 2))
    with sh.use_sharding(ctx.mesh, ctx.rules):
        assert sh.current_ctx() is not None
        assert sh.constrain(x, "act_batch", "act_seq", "act_embed") is x
        with pytest.raises(ValueError):
            sh.constrain(x, "act_batch", "act_seq")
    assert sh.current_ctx() is None


def test_agree_all_outside_a_model_group_is_the_flag():
    flag = torch.tensor(True)
    assert sh.agree_all(flag) is flag
    ctx, _ = _ctxs((2, 1))
    with sh.use_sharding(ctx.mesh, ctx.rules):
        assert sh.agree_all(flag) is flag          # model extent 1


def test_slot_axis_rank_rules():
    assert sh._slot_axis((8,), 8, 2) == jsh._slot_axis((8,), 8, 2) == 0
    for shape in ((8, 16, 128), (2, 8), (3, 8, 16, 128), (4, 4), (5,)):
        for batch, layers in ((8, 2), (4, 4), (4, None)):
            assert sh._slot_axis(shape, batch, layers) == \
                jsh._slot_axis(shape, batch, layers), (shape, batch, layers)


def test_local_slice_cuts_by_spec():
    t = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    ext = {"data": 2, "model": 4}
    got = sh.local_slice(t, (None, "model", None), {"data": 1, "model": 2},
                         ext)
    assert torch.equal(got, t[:, 4:6])
    got = sh.local_slice(t, (None, ("data", "model"), None),
                         {"data": 1, "model": 1}, ext)
    assert torch.equal(got, t[:, 5:6])


# ---------------------------------------------------------------------------
# serving state, plan, snapshot and metrics specs
# ---------------------------------------------------------------------------

def _runners(full, policy, merge):
    """The port's and the reference's runners of one policy, at the reduced
    dit-b2 (real tensors) or DiT-XL/2's full shapes (meta / abstract)."""
    if full:
        cfg, jcfg = get_config("dit-xl2"), jget_config("dit-xl2")
        window = 16
    else:
        cfg = get_reduced("dit-b2").replace(dtype="float32")
        jcfg = jget_reduced("dit-b2").replace(dtype="float32")
        window = 8
    kw = {"l2c_mask": np.zeros(cfg.num_layers, bool)} if policy == "l2c" \
        else {}
    fc, jfc = FastCacheConfig(), JFastCacheConfig()
    if merge:
        fc = FastCacheConfig(merge_enabled=True, merge_ratio=0.5,
                             merge_window=window)
        jfc = JFastCacheConfig(merge_enabled=True, merge_ratio=0.5,
                               merge_window=window)
    model = DiTModel(cfg, device="meta" if full else "cpu")
    return (CachedDiT(model, fc, policy=policy, **kw),
            JCachedDiT(build_model(jcfg), jfc, policy=policy, **kw))


@pytest.mark.parametrize("merge", [False, True], ids=["merge_off",
                                                      "merge_0.5"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "xl2"])
@pytest.mark.parametrize("policy", registered_policies())
def test_serve_state_specs_match(policy, full, merge):
    runner, jrunner = _runners(full, policy, merge)
    for rows in (2, 1):                       # CFG pairs, and the no-CFG path
        batch = rows * SLOTS
        state = runner.init_state(batch)
        jstate = jax.eval_shape(lambda: jrunner.init_state(batch))
        assert sorted(k for k, _ in _port_leaves(state)) == \
            sorted(_jax_paths(jstate))
        for mesh in MESHES:
            ctx, jctx = _ctxs(mesh)
            got = _port_specs(sh.serve_state_specs(
                state, ctx, batch=batch, layers=runner.L))
            want = _jax_specs(jsh.serve_state_specs(
                jstate, jctx, batch=batch, layers=jrunner.L))
            assert got == want, (mesh, rows)
            # a snapshot replicates every leaf
            snap = _port_specs(sh.serve_snapshot_specs(state, ctx))
            assert snap == _jax_specs(jsh.serve_snapshot_specs(jstate, jctx))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_serve_plan_specs_match(mesh):
    ctx, jctx = _ctxs(mesh)
    for slots in (4, 3, 8):
        plan = {"ts": np.zeros((slots, 50)), "ts_prev": np.zeros((slots, 50)),
                "guidance": np.zeros((slots,))}
        got = sh.serve_plan_specs(plan, ctx)
        want = jsh.serve_plan_specs(plan, jctx)
        assert got == {k: _tup(v) for k, v in want.items()}, slots


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_serve_metrics_specs_match(mesh):
    ctx, jctx = _ctxs(mesh)
    for kw in ({}, {"audit_layers": 3}, {"token_metrics": True}):
        m = tmetrics.init_device_metrics(SLOTS, device="cpu", **kw)
        jm = jmetrics.init_device_metrics(SLOTS, **kw)
        got = _port_specs(sh.serve_metrics_specs(m, ctx))
        assert got == _jax_specs(jsh.serve_metrics_specs(jm, jctx)), kw


def test_state_specs_need_a_ctx():
    runner, _ = _runners(False, "fastcache", False)
    with pytest.raises(ValueError, match="requires an active sharding"):
        sh.serve_state_specs(runner.init_state(2), batch=2)


# ---------------------------------------------------------------------------
# parameter axes and the DiT's param_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "xl2"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_dit_param_specs_match(mesh, full, kind):
    if full:
        cfg, jcfg = get_config("dit-xl2"), jget_config("dit-xl2")
    else:
        cfg, jcfg = get_reduced("dit-b2"), jget_reduced("dit-b2")
    defs = DiTModel(cfg, device="meta").param_defs()
    jdefs = build_model(jcfg).param_defs()
    ctx, jctx = _ctxs(mesh, kind)
    got = _port_specs(sh.param_specs(defs, ctx))
    assert got == _jax_specs(_ref_param_specs(jdefs, jctx))


def _ref_param_specs(jdefs, jctx):
    """The reference's ``param_shardings`` builds NamedShardings on a real
    mesh; its specs are ``spec_for`` of each def's shape and axes."""
    from repro.models.params import ParamDef as JParamDef
    return jax.tree.map(lambda d: jsh.spec_for(d.shape, d.axes, jctx), jdefs,
                        is_leaf=lambda x: isinstance(x, JParamDef))


def test_dit_param_defs_match_the_reference():
    """Shapes, axes and initializers of every def, at DiT-XL/2."""
    defs = DiTModel(get_config("dit-xl2"), device="meta").param_defs()
    jdefs = build_model(jget_config("dit-xl2")).param_defs()
    assert set(defs) == set(jdefs)
    assert set(defs["blocks"]) == set(jdefs["blocks"])
    pairs = [(k, defs[k], jdefs[k]) for k in defs if k != "blocks"]
    pairs += [(f"blocks/{k}", d, jdefs["blocks"][k])
              for k, d in defs["blocks"].items()]
    for key, d, jd in pairs:
        assert (tuple(d.shape), tuple(d.axes), d.init) == \
            (tuple(jd.shape), tuple(jd.axes), jd.init), key


def test_stack_defs_prepends_the_layers_axis():
    from repro_torch.models.layers import ParamDef, stack_defs
    d = stack_defs({"w": ParamDef((4, 8), "fan_in", axes=("embed", "ffn")),
                    "n": ParamDef((4,), "ones")}, 3)
    assert d["w"].shape == (3, 4, 8)
    assert d["w"].axes == ("layers", "embed", "ffn")
    assert d["n"].axes is None
    ctx, _ = _ctxs((2, 2), "train")
    assert sh.param_specs(d, ctx) == {"w": (None, "data", "model"),
                                      "n": (None, None)}
