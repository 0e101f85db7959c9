"""The port's dry run (``repro_torch.models.params``, the LLM families'
logical axes and trees, ``launch/mesh``'s production meshes,
``launch/specs.py``, ``launch/dryrun.py``, B7 on ``meta``) against the
reference's.

Parameter trees, specs, cache bytes and the model-FLOP accounting are
compared at every architecture's full config: the trees are shapes only
(the port's on ``meta``, the reference's ``ParamDef`` trees), and both
packages' rules read a mesh's axis names and extents alone, so one stub
mesh serves both at (16, 16) and (2, 16, 16).  The bundles are held to the
reference's compile on a (1, 1) CPU mesh whose axes are ``Auto``: this
JAX makes ``jax.make_mesh`` meshes with ``Explicit`` axes, on which the
reference's ``constrain`` raises.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import functools
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, ASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild_model
from repro.models.params import ParamDef as JParamDef
from repro.training import optimizer as joptimizer
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.cuda_kernels import ref
from repro_torch.cuda_kernels.flash_attention import flash_attention
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import (abstract_mesh, abstract_production_mesh,
                                     make_production_mesh)
from repro_torch.models.params import (ParamDef, abstract_params,
                                       count_params)
from repro_torch.models.registry import build_model
from repro_torch.training.loop import param_tree
from repro_torch.training.optimizer import make_optimizer

MESHES = ((16, 16), (2, 16, 16))
MESH_IDS = ["16x16", "2x16x16"]
RULES = {"train": ("train", {}), "prefill": ("prefill", {}),
         "decode": ("decode", {}),
         "long": ("decode", {"long_context": True})}
DECODERS = tuple(a for a in ASSIGNED_ARCHS
                 if not jget_config(a).is_encoder)


class StubMesh:
    """What both packages' rules read of a mesh: axis names and a devices
    array of the mesh's shape."""

    def __init__(self, dims):
        self.axis_names = (("pod",) if len(dims) == 3 else ()) + (
            "data", "model")
        self.devices = np.empty(dims, dtype=object)


def _ctxs(dims, rules):
    kind, flags = RULES[rules]
    m = StubMesh(dims)
    return (sh.ShardingCtx(m, sh.make_rules(kind, **flags)),
            jsh.ShardingCtx(m, jsh.make_rules(kind, **flags)))


def _tup(spec):
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                 for a in spec)


def _port_paths(tree_, is_leaf, prefix=()):
    """{path: leaf} of a port tree of dicts / named tuples."""
    if is_leaf(tree_):
        return {"/".join(prefix): tree_}
    out = {}
    if isinstance(tree_, dict):
        for k, v in tree_.items():
            out.update(_port_paths(v, is_leaf, prefix + (str(k),)))
    else:
        for f in tree_._fields:
            out.update(_port_paths(getattr(tree_, f), is_leaf,
                                   prefix + (f,)))
    return out


def _key(p):
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    raise TypeError(p)


def _jax_paths(tree_, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree_, is_leaf=is_leaf)[0]
    return {"/".join(_key(p) for p in path): leaf for path, leaf in flat}


def _is_jdef(x):
    return isinstance(x, JParamDef)


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return build_model(get_config(arch), device="meta")


@functools.lru_cache(maxsize=None)
def ref_model(arch):
    return jbuild_model(jget_config(arch))


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_defs_match_the_reference(arch):
    """Leaf for leaf: path, shape, dtype override, init, scale, axes; and
    the parameter count."""
    defs = port_model(arch).param_defs()
    jdefs = ref_model(arch).param_defs()
    got = {k: (tuple(d.shape), d.dtype, d.init, d.scale, tuple(d.axes))
           for k, d in _port_paths(defs, lambda x: isinstance(
               x, ParamDef)).items()}
    want = {k: (tuple(d.shape), d.dtype, d.init, d.scale, tuple(d.axes))
            for k, d in _jax_paths(jdefs, _is_jdef).items()}
    assert got == want
    assert count_params(defs) == sum(math.prod(d.shape) for d in
                                     _jax_paths(jdefs, _is_jdef).values())


def test_count_and_abstract_params():
    model = port_model("qwen3-0.6b")
    assert count_params(model.param_defs()) == 596_049_920
    assert count_params(model.param_defs()) == sum(
        p.numel() for p in model.parameters())
    abst = model.abstract_params()
    assert abst["final_norm"].dtype == torch.float32
    assert abst["embed"].dtype == torch.bfloat16
    assert abst["blocks"]["pos0"]["attn"]["wq"].shape == (28, 1024, 16, 128)
    assert all(t.device.type == "meta" for t in tree.leaves(abst))
    dit = port_model("dit-xl2").abstract_params()
    jdit = ref_model("dit-xl2").abstract_params()
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in _port_paths(dit, torch.is_tensor).items()} == {
        k: (tuple(s.shape), str(s.dtype))
        for k, s in _jax_paths(jdit).items()}


def test_the_port_tree_is_the_models_parameters():
    """``param_tree`` of a meta model has ``abstract_params``' leaves."""
    cfg = get_config("jamba-v0.1-52b")
    model = build_model(cfg, device="meta")
    got = {k: (tuple(t.shape), t.dtype)
           for k, t in _port_paths(param_tree(model), torch.is_tensor).items()}
    want = {k: (tuple(t.shape), t.dtype) for k, t in _port_paths(
        model.abstract_params(), torch.is_tensor).items()}
    assert got == want


# ---------------------------------------------------------------------------
# specs on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match(arch, mesh, rules):
    ctx, jctx = _ctxs(mesh, rules)
    got = {k: _tup(v) for k, v in _port_paths(
        sh.param_specs(port_model(arch).param_defs(), ctx),
        specs.is_spec).items()}
    want = {k: _tup(jsh.spec_for(d.shape, d.axes, jctx))
            for k, d in _jax_paths(ref_model(arch).param_defs(),
                                   _is_jdef).items()}
    assert got == want


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_optimizer_specs_match(arch, mesh, monkeypatch):
    """The config's optimizer: AdamW's mu / nu as the parameters, Adafactor's
    vr / vc; the specs line up with the port's state leaf for leaf and
    equal the reference's ``optimizer_shardings`` (its NamedShardings
    stubbed to their specs: a stub mesh has no devices)."""
    cfg = get_config(arch)
    ctx, jctx = _ctxs(mesh, "train")
    model = build_model(cfg, device="meta")
    opt = make_optimizer(cfg.optimizer)
    got_sp = specs.optimizer_specs(opt, model.param_defs(), ctx)
    for mod in (jspecs, jsh):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)
    want_sp = jspecs.optimizer_shardings(
        joptimizer.make_optimizer(cfg.optimizer),
        ref_model(arch).param_defs(), jctx)
    got = {k: _tup(v) for k, v in _port_paths(got_sp,
                                              specs.is_spec).items()}
    want = {k: _tup(v) for k, v in _jax_paths(
        want_sp, lambda x: isinstance(x, jax.sharding.PartitionSpec)
    ).items()}
    assert got == want
    state = opt.init(param_tree(model))
    leaves = {("/".join(str(p).lstrip(".") for p in path)): leaf
              for path, leaf in tree.flatten_with_path(state)}
    assert set(leaves) == set(got)
    ext = sh.mesh_extents(ctx.mesh)
    for key, spec in got.items():
        shape = getattr(leaves[key], "shape", ())
        assert len(spec) <= len(shape), key
        for n, axes in zip(shape, spec):
            split = math.prod(ext[a] for a in sh._as_tuple(axes))
            assert n % split == 0, (key, shape, spec)


def _ref_cache_bytes(arch, shape_name, jctx):
    shape = SHAPES[shape_name]
    jcfg = jspecs.resolve_config(arch, shape)
    window = min(shape.seq_len, jcfg.sliding_window or shape.seq_len)
    defs = jbuild_model(jcfg).cache_defs(shape.global_batch, window)
    ext = dict(zip(jctx.mesh.axis_names, jctx.mesh.devices.shape))
    total = 0
    for d in _jax_paths(defs, _is_jdef).values():
        spec = jsh.spec_for(d.shape, d.axes, jctx)
        split = math.prod(ext[a] for e in spec for a in jsh._as_tuple(e))
        item = np.dtype(d.dtype or jcfg.dtype).itemsize if (
            d.dtype or jcfg.dtype) != "bfloat16" else 2
        total += math.prod(d.shape) // split * item
    return total


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_bytes_per_device_match(arch, shape_name, mesh):
    """The port's cache (one stacked leaf per kind) and the reference's
    (``blocks/pos{i}``) hold the same per-device bytes; both carry
    ``step``, so the leaf sets differ by 0 bytes beyond the layout."""
    rules = "long" if shape_name == "long_500k" else "decode"
    ctx, jctx = _ctxs(mesh, rules)
    shape = SHAPES[shape_name]
    cfg = specs.resolve_config(arch, shape)
    window = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    model = build_model(cfg, device="meta")
    b = shape.global_batch
    got = specs.shard_bytes(model.abstract_cache(b, window),
                            sh.param_specs(model.cache_defs(b, window), ctx),
                            sh.mesh_extents(ctx.mesh))
    assert got == _ref_cache_bytes(arch, shape_name, jctx)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_active_params_and_model_flops_match(arch, shape_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert specs.active_params(cfg) == jspecs.active_params(jcfg)
    assert specs.model_flops(cfg, SHAPES[shape_name]) == \
        jspecs.model_flops(jcfg, jspecs.SHAPES[shape_name])


def test_skip_reason_and_resolve_config_match():
    for arch in ASSIGNED_ARCHS:
        for name, shape in SHAPES.items():
            assert specs.skip_reason(arch, name) == \
                jspecs.skip_reason(arch, name)
            assert specs.resolve_config(arch, shape).sliding_window == \
                jspecs.resolve_config(arch, shape).sliding_window
    assert specs.SWA_WINDOW == jspecs.SWA_WINDOW


# ---------------------------------------------------------------------------
# bundles against the reference's compile on a (1, 1) mesh
# ---------------------------------------------------------------------------

def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


# XLA's output_size_in_bytes also counts the output tuple's table of
# buffer pointers, 8 bytes per leaf
XLA_TUPLE_ENTRY_BYTES = 8


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_bundle_bytes_match_the_reference_compile(shape_name):
    """qwen3-0.6b: the per-device argument bytes equal the reference's
    compiled ``argument_size_in_bytes``; the output bytes plus XLA's tuple
    table equal its ``output_size_in_bytes``.  At train_4k the metrics
    leaves of both steps are compared by name and bytes (the port's rate
    is a host number, counted as the reference's f32 scalar)."""
    jb = jspecs.build_bundle("qwen3-0.6b", shape_name, _auto_mesh())
    compiled = jax.jit(jb.step_fn, in_shardings=jb.in_shardings,
                       out_shardings=jb.out_shardings).lower(
        *jb.args).compile()
    mem = compiled.memory_analysis()
    jout = _jax_paths(jax.eval_shape(jb.step_fn, *jb.args))
    mesh = abstract_mesh((1, 1))
    b = specs.build_bundle("qwen3-0.6b", shape_name, mesh)
    out = b.step_fn(*b.args)
    ext = sh.mesh_extents(mesh)
    assert specs.shard_bytes(b.args, b.in_specs, ext) == \
        mem.argument_size_in_bytes
    got_out = specs.shard_bytes(out, b.out_specs, ext)
    if shape_name == "train_4k":
        port_m = {k: specs.local_bytes(v, (), ext)
                  for k, v in out[2].items()}
        ref_m = {k.split("/")[-1]: int(v.size * v.dtype.itemsize)
                 for k, v in jout.items() if k.startswith("2/")}
        assert port_m == ref_m, (port_m, ref_m)
    assert got_out + XLA_TUPLE_ENTRY_BYTES * len(jout) == \
        mem.output_size_in_bytes
    assert b.meta.keys() == jb.meta.keys()
    assert b.meta == jb.meta


# the cuts of the cost check, one period each at a short sequence: (arch,
# layers, shape, seq); the forward (prefill) of all four, and the train
# step (forward + backward) where XLA compiles it in seconds (the unrolled
# Jamba and xLSTM train steps take it 30-40 s each)
COST_CUTS = [("qwen3-0.6b", 1, "prefill_32k", 256),
             ("arctic-480b", 1, "prefill_32k", 64),
             ("jamba-v0.1-52b", 8, "prefill_32k", 64),
             ("xlstm-1.3b", 8, "prefill_32k", 64),
             ("qwen3-0.6b", 1, "train_4k", 256),
             ("arctic-480b", 1, "train_4k", 64)]


def _ref_measure_cost():
    """The reference's ``_measure_cost``; importing its dry-run module sets
    ``XLA_FLAGS`` (512 host devices) for a JAX not yet started, so the
    variable is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _measure_cost
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _measure_cost


@pytest.mark.parametrize("cut", COST_CUTS,
                         ids=[f"{c[0]}-{c[2]}" for c in COST_CUTS])
def test_flops_within_5_percent_of_xla(cut):
    """At one period and a short sequence the port's FLOPs (products only,
    ``FlopCounterMode``) lie within 5% of XLA's count of the reference's
    step under ``unroll_inner`` (which counts elementwise work too)."""
    arch, layers, shape_name, seq = cut
    want = _ref_measure_cost()(arch, shape_name, _auto_mesh(), layers, 1,
                               seq=seq)["flops"]
    b = specs.build_bundle(arch, shape_name, abstract_mesh((1, 1)),
                           num_layers=layers, seq_override=seq)
    got = dryrun.counted(b.step_fn, *b.args)[1]["flops"]
    assert abs(got / want - 1.0) < 0.05, (got, want, got / want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

REF_RECORD_KEYS = {
    "arch", "shape", "mesh", "status", "skip_reason", "tag", "n_chips",
    "params", "meta", "per_device_flops", "per_device_bytes_accessed",
    "collective_bytes", "scan_compile", "memory_analysis",
    "model_flops_global", "model_flops_per_device", "useful_flops_ratio",
    "roofline", "lower_s", "compile_s", "cost_measure_s", "hlo_bytes"}


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-0.6b", "--shape", "long_500k", "--mesh", "single",
     "--mesh-shape", "2,2"],
    ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "multi",
     "--mesh-shape", "2,2,2"]], ids=["long_500k_2x2", "multi_2x2x2"])
def test_cli_small_meshes_are_ok(argv, tmp_path, capsys):
    """The reference's two red dry-run cases, on the port."""
    recs = dryrun.main(argv + ["--out", str(tmp_path)])
    assert "[dryrun] done: 1 ok, 0 skip, 0 fail" in capsys.readouterr().out
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec == json.loads(json.dumps(recs[0], default=str))
    assert REF_RECORD_KEYS <= set(rec)
    # a decode record: no sharded serving of the LLMs, so no count
    assert rec["collective_bytes"] is None
    assert rec["roofline"]["collective_s"] is None
    assert "no sharded serving" in rec["notes"]["collective_bytes"]
    assert rec["memory_analysis"]["temp_size_in_bytes"] is None
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
    assert rec["n_chips"] == math.prod(int(x) for x in argv[-1].split(","))
    assert rec["meta"]["cache_window"] in (8192, 32768)


def _fsdp_bytes(arch: str, dims) -> tuple:
    """(all-gather, reduce-scatter) bytes of one sharded train step, from
    the specs alone: each leaf cut over ``data`` is gathered over it, the
    result its model block (a block leaf twice: remat's recomputed forward
    gathers again), and its gradient reduce-scattered once to its block;
    each MoE dispatch (twice a layer) gathers the per-expert counts (int64)
    over ``data``."""
    cfg = get_config(arch)
    ctx = sh.ShardingCtx(abstract_mesh(dims), sh.make_rules("train"))
    defs = build_model(cfg, device="meta").param_defs()
    ext = sh.mesh_extents(ctx.mesh)
    gather = scatter = 0
    for key, d in _port_paths(defs, lambda x: isinstance(x, ParamDef)
                              ).items():
        spec = sh.spec_for(d.shape, d.axes, ctx)
        split = {a: ext[a] for e in spec for a in sh._as_tuple(e)}
        data = math.prod(n for a, n in split.items() if a != "model")
        if data == 1:
            continue
        item = 4 if (d.dtype or cfg.dtype) == "float32" else 2
        block = math.prod(d.shape) * item // math.prod(split.values())
        uses = 2 if key.startswith("blocks") and cfg.remat else 1
        gather += uses * block * data
        scatter += block
    if cfg.moe is not None:
        gather += 2 * cfg.num_layers * ext["data"] * cfg.moe.num_experts * 8
    return gather, scatter


def _qwen3_all_reduce(dims, batch: int, seq: int) -> int:
    """Qwen3-0.6B's all-reduce bytes on (data, model) with the heads, the
    ffn and the vocab cut over ``model`` and its 8 kv heads replicated
    (model = 16), bf16, remat on: per layer the f32 sums of the two
    row-parallel outputs in the forward and again in remat's recompute of
    the attention (the recompute stops before the FFN's sum, which nothing
    saved needs), the bf16 gradients of the replicated inputs of q, k and
    v (all kv heads) and of the FFN, and q_norm's gradient; the
    vocab-parallel lookup's sum, the head's input gradient, per 512-token
    chunk of the CE the max and the two sums; the loss's two sums over
    ``data``; the qk-norm weights' gradients over ``data`` (replicated);
    the global norm's two partial sums."""
    cfg = get_config("qwen3-0.6b")
    d_, m_ = dims
    b = batch // d_
    act = b * seq * cfg.d_model
    kv = b * seq * cfg.num_kv_heads * cfg.resolved_head_dim
    dh = cfg.resolved_head_dim
    layer = 3 * 4 * act + 2 * (act + 2 * kv + act) + 4 * dh
    top = 2 * act + 2 * act + (seq // 512) * (b * 512 * 4 * 3)
    other = 2 * 4 + 2 * cfg.num_layers * dh * 4 + 2 * 4
    return cfg.num_layers * layer + top + other


def _optimizer_all_reduce(arch: str, dims) -> int:
    """The all-reduce bytes of the global norm and of Adafactor's
    statistics, from the specs: each leaf seen as n local (D, F) matrices
    (a leaf of ndim >= 2); per leaf, f32, the row sums of the squares over
    the ranks that cut F (n * D_local), the column sums over those that cut
    D (n * F_local), the row statistics' sums over those that cut D (n) and
    the update's squares over every rank that cuts the leaf (one); a 1-D
    leaf its update's squares alone.  The global norm sums one square per
    distinct set of axes that cut leaves."""
    cfg = get_config(arch)
    ctx = sh.ShardingCtx(abstract_mesh(dims), sh.make_rules("train"))
    ext = sh.mesh_extents(ctx.mesh)
    defs = build_model(cfg, device="meta").param_defs()
    total, groups = 0, set()
    for d in _port_paths(defs, lambda x: isinstance(x, ParamDef)).values():
        spec = sh.spec_for(d.shape, d.axes, ctx)
        cuts = [sh._as_tuple(e) for e in spec]
        local = [n // math.prod(ext[a] for a in c)
                 for n, c in zip(d.shape, cuts)]
        every = {a for c in cuts for a in c}
        groups.add(frozenset(every))
        total += 4 * bool(every)
        if len(d.shape) >= 2:
            n = math.prod(local[:-2])
            total += 4 * n * local[-2] * bool(cuts[-1])
            total += 4 * n * (local[-1] + 1) * bool(cuts[-2])
    return total + 4 * sum(1 for g in groups if g)


def _arctic_all_reduce(dims, batch: int, seq: int) -> int:
    """Arctic's all-reduce bytes on (data, model) (model = 16), bf16, remat
    on.  Its 56 heads and 8 kv heads do not divide ``model``: the
    attention runs whole on every model rank, with no sum.  Per layer, the
    MoE: the f32 sum over ``model`` of this rank's experts' combine and its
    block of the dense FFN, in the forward and again in remat's recompute,
    the aux loss's 2E f32 sums over ``data`` both times, and in the
    backward the bf16 gradient of the replicated input of the experts and
    the dense FFN and the f32 gradient of the top-k weights.  Then as for
    Qwen3: the vocab-parallel lookup's sum, the head's input gradient, per
    512-token chunk of the CE the max and the two sums, the loss's two
    sums; and the optimizer's (``_optimizer_all_reduce``)."""
    cfg = get_config("arctic-480b")
    d_, m_ = dims
    assert cfg.num_heads % m_ and cfg.num_kv_heads % m_
    b = batch // d_
    t = b * seq
    act = t * cfg.d_model
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    layer = 2 * 4 * act + 2 * 4 * 2 * e + 2 * act + 4 * t * k
    top = 2 * act + 2 * act + (seq // 512) * (b * 512 * 4 * 3) + 2 * 4
    return (cfg.num_layers * layer + top
            + _optimizer_all_reduce("arctic-480b", dims))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "arctic-480b"])
def test_train_records_count_their_collectives(arch):
    """A train record on (16, 16) carries the sharded step's collective
    bytes by kind (``collective_bytes``, ``scan_compile``) and
    ``collective_s`` over NVLink; all-gather and reduce-scatter equal the
    specs' FSDP bytes, the all-reduce each arch's formula, no
    all-to-all."""
    rec = dryrun.run_one(arch, "train_4k", False, "", measure_cost=False)
    assert rec["status"] == "ok", rec.get("error")
    got = rec["collective_bytes"]
    shape = SHAPES["train_4k"]
    gather, scatter = _fsdp_bytes(arch, (16, 16))
    reduce = (_qwen3_all_reduce if arch == "qwen3-0.6b" else
              _arctic_all_reduce)((16, 16), shape.global_batch, shape.seq_len)
    assert got == {"all-gather": gather, "reduce-scatter": scatter,
                   "all-reduce": reduce, "all-to-all": 0,
                   "total": gather + scatter + reduce}
    assert rec["scan_compile"]["collectives"] == got
    assert rec["roofline"]["collective_s"] == got["total"] / \
        dryrun.NVLINK_BW
    assert rec["notes"]["collective_bytes"].startswith("the sharded train")


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "prefill_32k"),
                                        ("xlstm-1.3b", "train_4k")])
def test_records_without_a_count_say_why(arch, shape):
    reason = dryrun.collectives_null_reason(get_config(arch), SHAPES[shape])
    assert reason and ("serving" in reason or "inner axis" in reason)
    assert dryrun.collectives_null_reason(get_config("qwen3-0.6b"),
                                          SHAPES["train_4k"]) is None


def test_cli_skips_the_encoders_decode(capsys):
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", ""])
    assert "[dryrun] done: 0 ok, 1 skip, 0 fail" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--attn-chunk", "4096"],
                                  ["--moe-constrain-dispatch"]])
def test_cli_refuses_the_xla_only_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--out", ""] + flag)
    assert e.value.code == 2
    assert "the port's eager step has no counterpart" in \
        capsys.readouterr().err


def test_a_failing_step_fails_the_record(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no such step")
    monkeypatch.setattr(dryrun, "build_bundle", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--out", ""])
    assert e.value.code == 1
    assert "0 ok, 0 skip, 1 fail" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the mesh, the cache defs, B7 on meta
# ---------------------------------------------------------------------------

def test_production_meshes():
    """The dry run's production meshes are abstract; the real one needs a
    process group of their size."""
    one = abstract_production_mesh()
    two = abstract_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs a process group of 256"):
        make_production_mesh()
    assert sh.mesh_extents(one) == {"data": 16, "model": 16}
    assert sh.mesh_extents(two) == {"pod": 2, "data": 16, "model": 16}
    assert (one.size, two.size) == (256, 512)
    ctx = sh.ShardingCtx(two, sh.make_rules("train"))
    assert sh.spec_for((256, 4096), ("act_batch", "act_seq"), ctx) == \
        (("pod", "data"), None)
    with pytest.raises(ValueError):
        abstract_mesh((4,))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_cache_defs_are_the_init_cache(arch):
    from repro_torch.configs import get_reduced
    model = build_model(get_reduced(arch).replace(dtype="float32"),
                        device="cpu")
    cache = model.init_cache(3, 8)
    abst = model.abstract_cache(3, 8)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in abst.items()}
    assert list(cache) == list(abst)
    if "pos" in cache:
        assert bool((cache["pos"] == -1).all())
    for name, d in model.cache_defs(3, 8).items():
        assert len(d.axes) == len(d.shape), name
        assert d.axes[0] == ("act_batch" if name == "step" else "layers")


@pytest.mark.parametrize("positions", [False, True])
def test_flash_attention_on_meta_gives_the_plain_twins_shape(positions):
    q = torch.empty(2, 8, 64, 32, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 64, 32, dtype=torch.bfloat16, device="meta")
    kw = {}
    if positions:
        kw = {"q_pos": torch.empty(1, 64, dtype=torch.int32, device="meta"),
              "kv_pos": torch.empty(1, 64, dtype=torch.int32,
                                    device="meta")}
    before = flash_attention.launches
    out = flash_attention(q, k, k, causal=True, **kw)
    assert flash_attention.launches == before
    qc, kc = (torch.zeros(t.shape, dtype=t.dtype) for t in (q, k))
    kwc = {n: torch.zeros(t.shape, dtype=t.dtype) for n, t in kw.items()}
    want = ref.flash_attention(qc, kc, kc, causal=True, **kwc)
    assert out.device.type == "meta"
    assert (out.shape, out.dtype) == (want.shape, want.dtype)


def test_flash_attention_refuses_other_devices():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 32, device="xpu")
        with pytest.raises(ValueError, match="CPU, CUDA or meta"):
            flash_attention(q, q, q, causal=True)


def test_abstract_params_of_overridden_dtypes():
    defs = {"a": ParamDef((2, 3), "zeros", dtype="int32",
                          axes=("act_batch", None)),
            "b": {"c": ParamDef((4,), "ones")}}
    out = abstract_params(defs, "bfloat16")
    assert out["a"].dtype == torch.int32 and out["a"].device.type == "meta"
    assert out["b"]["c"].dtype == torch.bfloat16
    assert count_params(defs) == 10


# ---------------------------------------------------------------------------
# the meta step counts what a real step runs
# ---------------------------------------------------------------------------

def _train_parts(cfg, device, batch, seq):
    from repro_torch.models.transformer import TransformerModel
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import cosine_schedule
    model = TransformerModel(cfg, device=device)
    if device == "cpu":
        model.init(torch.Generator("cpu").manual_seed(0))
    params = param_tree(model)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(params)
    tokens = (torch.zeros((batch, seq), dtype=torch.int32, device=device)
              if device == "cpu" else
              torch.empty((batch, seq), dtype=torch.int32, device=device))
    step = make_train_step(model, opt, cosine_schedule(3e-4, 100, 10_000))
    return model, step, (params, state, {"tokens": tokens})


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "arctic-480b",
                                  "jamba-v0.1-52b", "xlstm-1.3b"])
def test_meta_step_counts_what_the_cpu_step_runs(arch):
    """The reduced config's train step on ``meta`` and on the CPU: the same
    FlopCounterMode count, and the meta arguments' bytes are the CPU
    tensors' (the card tie of chip_smoke.py, at a CPU size)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch).replace(dtype="float32")
    _, meta_step, meta_args = _train_parts(cfg, "meta", 2, 16)
    got = dryrun.counted(meta_step, *meta_args)[1]["flops"]
    _, cpu_step, cpu_args = _train_parts(cfg, "cpu", 2, 16)
    with FlopCounterMode(display=False) as fc:
        cpu_step(*cpu_args)
    assert got == fc.get_total_flops() > 0
    ext = {"data": 1, "model": 1}
    assert specs.shard_bytes(meta_args, (), ext) == specs.shard_bytes(
        cpu_args, (), ext)


def test_meta_memo_changes_no_count():
    """``counted`` memoizes ops on ``meta`` (``MetaMemo``); its counts and
    the outputs' shapes are those of the plain counters without it."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_reduced
    cfg = get_reduced("xlstm-1.3b")
    _, step, args = _train_parts(cfg, "meta", 2, 32)
    with FlopCounterMode(display=False) as fc, dryrun.ByteCounter() as bc:
        plain = step(*args)
    _, step2, args2 = _train_parts(cfg, "meta", 2, 32)
    fast, got = dryrun.counted(step2, *args2)
    assert got == {"flops": float(fc.get_total_flops()),
                   "bytes": float(bc.bytes)}
    shapes = lambda out: [(tuple(t.shape), t.dtype)  # noqa: E731
                          for t in tree.leaves(out)
                          if isinstance(t, torch.Tensor)]
    assert shapes(fast) == shapes(plain)
