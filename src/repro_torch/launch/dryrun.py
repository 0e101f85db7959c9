"""The dry run on the production mesh, after the reference's
``launch/dryrun.py``: for every (architecture x input shape x mesh) run the
full-size step on the ``meta`` device (shapes only: no card, no memory),
account its per-device argument and output bytes under the mesh's specs,
measure its FLOPs and bytes moved, and write one JSON record each.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

What each part of a record is here, against the reference's compile:

* proof: the whole step at full depth, global batch and sequence runs on
  ``meta`` tensors through the port's eager code (the counterpart of
  ``lower`` + ``compile``).  A step that cannot run fails the record with
  its traceback.  Where the sLSTM's token loop makes a full-sequence run
  too slow (the SSM family's train and prefill shapes), the proof runs at
  full depth at the largest probe sequence, and ``proof_seq_len`` says so.
  The step is the same global program on every mesh, so a sweep runs it
  once per (arch, shape) and the other meshes' records reuse it
  (``proof_reused``); ``MetaMemo`` spares repeated ops their meta
  functions and the FLOP counter's dispatch.
* cost: the reference's scheme as it is: the step at depth ``period`` and
  ``2 * period``, extrapolated linearly to the full depth; for the SSM and
  hybrid families' train and prefill shapes each depth is fitted in S over
  the probe sequences.  FLOPs are ``FlopCounterMode``'s (products only);
  bytes are every non-view aten op's input plus output bytes
  (``ByteCounter``), what an eager step moves, so more than XLA's fused
  count.  The per-device numbers are the global ones over ``n_chips``,
  an even split (the reference's count is of its partitioned program).
* memory: ``argument_size_in_bytes`` / ``output_size_in_bytes`` are the
  sums of the local shards of the step's inputs / outputs under their
  specs (``specs.shard_bytes``), exact; there is no compiler, so the
  temporaries and the generated code have no size (``null``).
* collectives: for a train record of an attention-only family (dense,
  MoE, VLM, audio), the sharded step (``training/sharded.py``) runs on
  ``meta`` at the local shard shapes of rank coordinates 0 of the record's
  mesh, through counting comms (``distributed/collectives.py``: nothing
  moves, each call's result size is counted), the counterpart of the
  reference's HLO parse (``distributed/hlo.py``): ``collective_bytes`` by
  kind per device and step, and ``collective_s`` = total over NVLink's
  bandwidth.  Prefill and decode records, and the SSM and hybrid
  families, stay ``null``: the port has no sharded serving of the LLMs,
  and the sharded step does not cut the mixers' ``inner`` axis yet.
* roofline: on the H100's peaks (below), per device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.sharding import mesh_extents
from repro_torch.launch.mesh import abstract_mesh, abstract_production_mesh
from repro_torch.launch.specs import (batch_specs, build_bundle, model_flops,
                                      resolve_config, shard_bytes,
                                      skip_reason)
from repro_torch.models import flags as model_flags
from repro_torch.models.transformer import TransformerModel
from repro_torch.training.loop import param_tree
from repro_torch.training.optimizer import cosine_schedule, make_optimizer
from repro_torch.training.sharded import (ATTENTION_ONLY, counting_train_mesh,
                                          cut_model, make_sharded_train_step)

# NVIDIA H100 SXM (80 GB HBM3) roofline denominators, per card
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 900e9            # NVLink 4, 18 links: bytes/s, both directions

NOTES = {
    "temp_size_in_bytes": "no compiler: an eager step's temporaries have "
                          "no static size",
    "generated_code_size_in_bytes": "no compiler",
    "alias_size_in_bytes": "no compiler",
    "collective_bytes": "the sharded train step on meta at rank "
                        "coordinates 0, through counting comms: each "
                        "call's result bytes on this device, by kind",
    "per_device": "global FLOPs and bytes over n_chips, an even split",
    "bytes_accessed": "every non-view aten op's input and output bytes "
                      "(eager, unfused)",
    "hlo_bytes": "no HLO",
}


def _meta_key(x):
    """A hashable key of an op argument's metadata (TypeError if none)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_meta_key(v) for v in x)
    if isinstance(x, (int, float, bool, str, type(None), torch.dtype,
                      torch.device, torch.layout, torch.memory_format)):
        return x
    raise TypeError(type(x))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every non-view aten op's tensor inputs and
    outputs: the traffic of an eager step with no fusion."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += _op_bytes(func, args, kwargs, out)
        return out


def _op_bytes(func, args, kwargs, out) -> int:
    if func.is_view:
        return 0
    return sum(t.numel() * t.element_size()
               for t in _tensors((args, kwargs, out)))


class MetaMemo(TorchDispatchMode):
    """``ByteCounter`` over a ``FlopCounterMode`` that runs the ``meta``
    device faster.  A token loop runs the same few ops on the same shapes
    S times; on ``meta`` each op's Python meta function costs ~0.2 ms and
    the FLOP counter's dispatch as much again.  So a functional op (no
    view, no mutation, no alias) on meta tensors is memoized by the op and
    its arguments' metadata (shapes, strides, dtypes and the non-tensor
    arguments): its outputs' metadata, the FLOPs the counter below added
    for it and its bytes.  A repeat gets fresh ``meta`` tensors of that
    metadata and adds the same counts without running below; anything
    else runs below and is counted as it runs.  The counts are those of
    ``ByteCounter`` over ``FlopCounterMode`` (the FLOP formulas read
    shapes and arguments only)."""

    def __init__(self, counter: FlopCounterMode):
        super().__init__()
        self.counter = counter
        self.bytes = 0
        self.memo_flops = 0
        self.memo: Dict = {}

    @property
    def flops(self) -> int:
        return self.counter.get_total_flops() + self.memo_flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:              # no FLOPs, no bytes: past the counter
            with torch._C._DisableTorchDispatch():
                return func(*args, **kwargs)
        schema = func._schema
        key = None
        if not (schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns)):
            try:
                key = (func, _meta_key(args),
                       _meta_key(sorted(kwargs.items())))
            except TypeError:
                key = None
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            kind, metas, flops, nbytes = hit
            self.memo_flops += flops
            self.bytes += nbytes
            with torch._C._DisableTorchDispatch():
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in metas]
            return outs[0] if kind is None else kind(outs)
        before = self.counter.get_total_flops()
        out = func(*args, **kwargs)
        nbytes = _op_bytes(func, args, kwargs, out)
        self.bytes += nbytes
        outs = [out] if isinstance(out, torch.Tensor) else out
        if (key is not None and isinstance(outs, (list, tuple)) and outs
                and all(isinstance(o, torch.Tensor)
                        and o.device.type == "meta" for o in outs)):
            self.memo[key] = (
                None if isinstance(out, torch.Tensor) else type(out),
                [(tuple(o.shape), o.stride(), o.dtype) for o in outs],
                self.counter.get_total_flops() - before, nbytes)
        return out


def counted(fn, *args):
    """Run ``fn(*args)`` under the FLOP and byte counters (``MetaMemo``
    over ``FlopCounterMode``): (output, {"flops", "bytes"})."""
    with FlopCounterMode(display=False) as fc, MetaMemo(fc) as mm:
        out = fn(*args)
    return out, {"flops": float(mm.flops), "bytes": float(mm.bytes)}


def probe_seqs(cfg, shape) -> Optional[List[int]]:
    """The reference's probe sequences (``dryrun.py:183-192``): the SSM
    family (linear in S) at 512 and 1024, the hybrid (quadratic) at 1024,
    2048 and 3072, for train and prefill; None elsewhere."""
    if cfg.family not in ("ssm", "hybrid") or shape.kind not in (
            "train", "prefill"):
        return None
    s = shape.seq_len
    if cfg.family == "ssm":
        seqs = [min(512, s), min(1024, s)]
    else:
        seqs = [min(1024, s), min(2048, s), min(3072, s)]
    return None if len(set(seqs)) < len(seqs) else seqs


def _measure_cost(arch, shape_name, mesh, num_layers, prefix_groups,
                  seq=None, attn_seq_shard=False) -> Dict[str, float]:
    bundle = build_bundle(arch, shape_name, mesh,
                          prefix_groups=prefix_groups,
                          num_layers=num_layers, seq_override=seq,
                          attn_seq_shard=attn_seq_shard)
    return counted(bundle.step_fn, *bundle.args)[1]


def _measure_at_depth(arch, shape_name, mesh, num_layers, prefix_groups,
                      target_seq, seqs, attn_seq_shard=False):
    """Global cost at one depth; over ``seqs`` fitted in S (a quadratic,
    or a line through two probes) and evaluated at ``target_seq``."""
    if not seqs:
        return _measure_cost(arch, shape_name, mesh, num_layers,
                             prefix_groups, attn_seq_shard=attn_seq_shard)
    probes = [_measure_cost(arch, shape_name, mesh, num_layers,
                            prefix_groups, seq=s,
                            attn_seq_shard=attn_seq_shard) for s in seqs]
    xs = np.asarray(seqs, dtype=float)

    def fit(key):
        ys = np.asarray([p[key] for p in probes], dtype=float)
        coeff = np.polyfit(xs, ys, min(2, len(xs) - 1))
        return float(np.polyval(coeff, target_seq))

    return {"flops": fit("flops"), "bytes": fit("bytes")}


def _extrapolate(c1, c2, l1: int, l2: int, l: int) -> Dict[str, float]:
    return {k: max(0.0, c1[k] + (c2[k] - c1[k]) * (l - l1) / (l2 - l1))
            for k in ("flops", "bytes")}


def global_cost(arch: str, shape_name: str, mesh, prefix_groups: int = 1,
                attn_seq_shard: bool = False) -> Dict[str, float]:
    """The step's global FLOPs and bytes at full size by the reference's
    depth extrapolation (and sequence fit)."""
    cfg = get_config(arch)
    period = len(cfg.block_pattern) or 1
    shape = SHAPES[shape_name]
    seqs = probe_seqs(cfg, shape)
    c1, c2 = (_measure_at_depth(arch, shape_name, mesh, depth,
                                prefix_groups, shape.seq_len, seqs,
                                attn_seq_shard=attn_seq_shard)
              for depth in (period, 2 * period))
    return _extrapolate(c1, c2, period, 2 * period, cfg.num_layers)


def collectives_null_reason(cfg, shape) -> Optional[str]:
    """Why a record has no collective count (None when it has one)."""
    if shape.kind != "train":
        return ("the port has no sharded serving of the LLMs (prefill, "
                "decode): only the train step runs on a mesh")
    if cfg.family not in ATTENTION_ONLY:
        return ("the SSM and hybrid families train on one device: the "
                "sharded step does not cut the mixers' inner axis yet")
    return None


def collective_bytes(cfg, global_batch: int, seq: int,
                     dims: Sequence[int]) -> Dict[str, int]:
    """The collective bytes of one sharded train step of ``cfg`` (a global
    batch of ``global_batch`` x ``seq``) on a mesh of ``dims``, per device
    by kind and ``total``: the step on ``meta`` at rank coordinates 0's
    shard shapes, through counting comms."""
    mesh = counting_train_mesh(tuple(dims), global_batch)
    model = cut_model(TransformerModel(cfg, device="meta"), mesh)
    params = param_tree(model)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(params)
    step = make_sharded_train_step(model, opt,
                                   cosine_schedule(3e-4, 100, 10_000), mesh)
    rows = global_batch // math.prod(mesh.extents[a]
                                     for a in mesh.batch_axes)
    batch = batch_specs(cfg, rows, seq, train=True)[0]
    step(params, state, batch)
    return mesh.counter.read()


def make_mesh(multi_pod: bool, mesh_shape: str = ""):
    if mesh_shape:
        return abstract_mesh(int(x) for x in mesh_shape.split(","))
    return abstract_production_mesh(multi_pod=multi_pod)


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            prefix_groups: int = 1, tag: str = "", mesh_shape: str = "",
            measure_cost: bool = True, attn_seq_shard: bool = False,
            memo: Optional[Dict] = None) -> dict:
    """One record.  ``memo`` keeps each (arch, shape)'s proof (its counts
    and outputs) and global cost across meshes: the step on ``meta`` is
    the same global program on every mesh; only the specs differ."""
    mesh_name = "multi" if multi_pod else "single"
    if mesh_shape:
        mesh_name = f"mesh{mesh_shape.replace(',', 'x')}"
    reason = skip_reason(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "skip", "skip_reason": reason, "tag": tag}
    if reason:
        print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}", flush=True)
        return rec
    memo = {} if memo is None else memo
    try:
        mesh = make_mesh(multi_pod, mesh_shape)
        extents = mesh_extents(mesh)
        n_chips = mesh.size
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        seqs = probe_seqs(cfg, shape)
        kinds = set(cfg.layer_kinds)
        proof_seq = (max(seqs) if seqs and "slstm" in kinds
                     and "attn" not in kinds else None)
        key = (arch, shape_name, prefix_groups, attn_seq_shard,
               model_flags.MOE_GATHER_DECODE, model_flags.CE_REMAT)
        t0 = time.perf_counter()
        bundle = build_bundle(arch, shape_name, mesh,
                              prefix_groups=prefix_groups,
                              attn_seq_shard=attn_seq_shard)
        t_build = time.perf_counter() - t0
        reused = ("proof",) + key in memo
        if not reused:
            run = bundle
            if proof_seq is not None:
                run = build_bundle(arch, shape_name, mesh,
                                   prefix_groups=prefix_groups,
                                   seq_override=proof_seq,
                                   attn_seq_shard=attn_seq_shard)
            t0 = time.perf_counter()
            out, proof = counted(run.step_fn, *run.args)
            memo[("proof",) + key] = (out, proof,
                                      time.perf_counter() - t0)
            del run
        out, proof, t_proof = memo[("proof",) + key]
        # with no attention layer the outputs (parameters, optimizer
        # state, metrics, or logits and recurrent state) do not depend on
        # S, so a proof at the probe sequence gives them too
        args_b = shard_bytes(bundle.args, bundle.in_specs, extents)
        out_b = shard_bytes(out, bundle.out_specs, extents)
        mem_rec = {"argument_size_in_bytes": args_b,
                   "output_size_in_bytes": out_b,
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None,
                   "alias_size_in_bytes": None}

        t0 = time.perf_counter()
        if not measure_cost:
            exact = proof         # the proof's own counts, as the reference
        else:
            if ("cost",) + key not in memo:
                memo[("cost",) + key] = global_cost(
                    arch, shape_name, mesh, prefix_groups, attn_seq_shard)
            exact = memo[("cost",) + key]
        t_cost = time.perf_counter() - t0

        t0 = time.perf_counter()
        coll, t_coll = None, None
        why_null = collectives_null_reason(cfg, shape)
        if why_null is None:
            ckey = ("collectives", mesh_name) + key
            if ckey not in memo:
                memo[ckey] = collective_bytes(
                    resolve_config(arch, shape), shape.global_batch,
                    shape.seq_len, tuple(extents.values()))
            coll = memo[ckey]
            t_coll = round(time.perf_counter() - t0, 2)

        notes = dict(NOTES)
        if why_null is not None:
            notes["collective_bytes"] = why_null
        if proof_seq:
            notes["proof_seq_len"] = (
                f"the sLSTM token loop: the proof ran at full depth at "
                f"S={proof_seq}, the largest probe sequence; the outputs "
                f"of a stack with no attention layer do not depend on S")
        flops, nbytes = exact["flops"] / n_chips, exact["bytes"] / n_chips
        mflops = model_flops(cfg, shape)
        terms = {"compute_s": flops / PEAK_FLOPS,
                 "memory_s": nbytes / HBM_BW,
                 "collective_s": (None if coll is None
                                  else coll["total"] / NVLINK_BW)}
        terms["dominant"] = max((k for k, v in terms.items()
                                 if v is not None),
                                key=lambda k: terms[k])
        rec.update({
            "status": "ok",
            "n_chips": n_chips,
            "params": bundle.meta["params"],
            "meta": bundle.meta,
            "per_device_flops": flops,
            "per_device_bytes_accessed": nbytes,
            "collective_bytes": coll,
            "scan_compile": {"flops": proof["flops"],
                             "bytes": proof["bytes"], "collectives": coll,
                             "collectives_static": coll},
            "memory_analysis": mem_rec,
            "model_flops_global": mflops,
            "model_flops_per_device": mflops / n_chips,
            "useful_flops_ratio": ((mflops / n_chips) / flops
                                   if flops else 0.0),
            "roofline": terms,
            "lower_s": round(t_build, 2),
            "compile_s": round(t_proof, 2),
            "proof_reused": reused,
            "cost_measure_s": round(t_cost, 2),
            "collective_count_s": t_coll,
            "hlo_bytes": None,
            "proof_seq_len": proof_seq or shape.seq_len,
            "notes": notes,
        })
        print(f"[dryrun] OK {arch} x {shape_name} x {mesh_name}"
              f" flops/dev={flops:.3e} bytes/dev={nbytes:.3e}"
              f" args/dev={args_b / 2**30:.2f}GiB"
              f" useful={rec['useful_flops_ratio']:.2f}"
              f" proof={t_proof:.1f}s{' (reused)' if reused else ''}"
              f" cost={t_cost:.1f}s", flush=True)
        coll_s = ("null" if coll is None
                  else f"{terms['collective_s']:.4e}")
        print(f"         roofline: compute_s={terms['compute_s']:.4e}"
              f" memory_s={terms['memory_s']:.4e}"
              f" collective_s={coll_s}"
              f" dominant={terms['dominant']}", flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] FAIL {arch} x {shape_name} x {mesh_name}: {e}",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def sweep(archs: Sequence[str], shapes: Sequence[str],
          meshes: Sequence[bool], out_dir: str, **kw) -> List[dict]:
    memo: Dict = {}
    return [run_one(arch, shape, mp, out_dir, memo=memo, **kw)
            for arch in archs for shape in shapes for mp in meshes]


# the reference's flags that steer XLA alone (its models/flags.py)
XLA_ONLY = {"attn_chunk": "--attn-chunk sets the size above which XLA "
                          "takes chunked attention",
            "moe_constrain_dispatch": "--moe-constrain-dispatch puts XLA "
                                      "sharding constraints on the MoE "
                                      "dispatch"}


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--prefix-groups", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh-shape", default="",
                    help="override mesh, e.g. '2,2' (small-mesh tests)")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost extrapolation (the proof's own "
                         "counts are reported)")
    ap.add_argument("--moe-gather-decode", action="store_true",
                    help="gather-based MoE for decode shapes")
    ap.add_argument("--attn-seq-shard", action="store_true",
                    help="shard attention q/logits seq over `model`")
    ap.add_argument("--attn-chunk", type=int, default=None,
                    help="refused: steers only XLA")
    ap.add_argument("--moe-constrain-dispatch", action="store_true",
                    help="refused: steers only XLA")
    ap.add_argument("--ce-remat", action="store_true",
                    help="rematerialize chunked-CE logits")
    args = ap.parse_args(argv)
    for name, what in XLA_ONLY.items():
        if getattr(args, name) not in (None, False):
            ap.error(f"{what}; the port's eager step has no counterpart")
    model_flags.CE_REMAT = args.ce_remat
    model_flags.MOE_GATHER_DECODE = args.moe_gather_decode

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t0 = time.perf_counter()
    results = sweep(archs, shapes, meshes, args.out,
                    prefix_groups=args.prefix_groups, tag=args.tag,
                    mesh_shape=args.mesh_shape,
                    measure_cost=not args.no_cost,
                    attn_seq_shard=args.attn_seq_shard)
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    fail = sum(r["status"] == "fail" for r in results)
    print(f"[dryrun] {len(results)} records in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(f"[dryrun] done: {ok} ok, {skip} skip, {fail} fail", flush=True)
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
