"""Rank processes for ``tests/test_torch_sharded_training.py``.

``MeshJobs({(data, model): jobs}, workdir)`` starts ``data * model``
processes per mesh (the launcher's ``RankGroup``), all meshes at once
(the jobs pickled under ``workdir``), joins each mesh's
into a ``gloo`` group on localhost and has each rank run its mesh's jobs
in order through ``training.sharded``; ``.results()`` collects rank 0's
answers (the other ranks answer None).  This module imports only the
port, never ``tests/conftest.py`` (which imports JAX): each child imports
it afresh, and runs one PyTorch thread.

A job is a dict: ``name``, ``cfg`` (a port config), ``params`` (the
reference's global parameter tree as numpy arrays), ``batches`` (global
numpy batches, one a step), ``lr`` (``cosine_schedule``'s arguments) and
optionally ``transport`` (``staged``, the default, or ``native``) and
``trace`` (record the MoE's kept copies).  Rank 0 answers, per step: the
metrics, this rank's collective bytes by kind, and the gathered clipped
gradients, parameters after the step and optimizer state (numpy trees).
"""
from typing import Dict, List, Tuple

import numpy as np
import torch


def _np_tree(t):
    from repro_torch import tree
    return None if t is None else tree.map(
        lambda x: x.detach().float().numpy().copy()
        if isinstance(x, torch.Tensor) else x, t)


def _run(job: Dict, device_mesh) -> Dict:
    from repro_torch import bridge
    from repro_torch.data.synthetic import rows_of
    from repro_torch.distributed import collectives
    from repro_torch.launch.specs import optimizer_specs
    from repro_torch.models import layers
    from repro_torch.models.transformer import TransformerModel
    from repro_torch.training import loop, optimizer, sharded

    global_batch = job["batches"][0][next(iter(job["batches"][0]))].shape[0]
    mesh = sharded.train_mesh(device_mesh, "gloo", global_batch)
    if job.get("transport", "staged") != "staged":
        mesh = collectives.device_mesh_comms(
            device_mesh, job["transport"]).with_batch_axes(mesh.batch_axes)
    model = TransformerModel(job["cfg"], device="cpu")
    bridge.transformer_params_from_jax(job["params"], model)
    sharded.cut_model(model, mesh)
    params = loop.param_tree(model)
    opt = optimizer.make_optimizer(job["cfg"].optimizer)
    state = opt.init(params)
    specs = sharded.leaf_specs(model, mesh)
    ost = optimizer_specs(opt, model.param_defs(), sharded.train_ctx(mesh))
    step = sharded.make_sharded_train_step(
        model, opt, optimizer.cosine_schedule(*job["lr"]), mesh)
    rows = rows_of(global_batch, sharded.data_shard(mesh))
    steps = []
    layers.MOE_TRACE = [] if job.get("trace") else None
    for b in job["batches"]:
        local = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                 for k, v in b.items()}
        mesh.counter.reset()
        params, state, met = step(params, state, local)
        counts = mesh.counter.read()
        rec = {"metrics": loop.host_metrics(met), "counts": counts,
               "grads": _np_tree(sharded.gather_tree(step.grads, specs,
                                                     mesh)),
               "params": _np_tree(sharded.gather_tree(params, specs, mesh))}
        rec["state"] = {f: _np_tree(sharded.gather_tree(
            getattr(state, f), getattr(ost, f), mesh))
            for f in state._fields if f != "step"}
        steps.append(rec)
    out = {"steps": steps, "batch_axes": mesh.batch_axes}
    if layers.MOE_TRACE is not None:
        out["kept"] = [t.numpy() for t in layers.MOE_TRACE]
        layers.MOE_TRACE = None
    return out


def _rank_main(rank, world, port, topo, path):
    torch.set_num_threads(1)
    import pickle
    import torch.distributed as dist
    with open(path, "rb") as f:
        jobs = pickle.load(f)
    from repro_torch.launch.mesh import init_ranks, make_mesh
    init_ranks(rank, world, port=port, backend="gloo")
    try:
        device_mesh = make_mesh(*topo)
        res = {}
        for job in jobs:
            got = _run(job, device_mesh)
            if job.get("trace"):        # every data rank's kept copies
                every = [None] * world
                dist.all_gather_object(every, got["kept"])
                got["kept_by_rank"] = every
            res[job["name"]] = got if rank == 0 else None
    finally:
        dist.destroy_process_group()
    return res


class MeshJobs:
    """Rank processes of several meshes, started at once (each mesh its
    own process group, ``launch.mesh.RankGroup``); ``results()`` waits for
    them and gives rank 0's answers by mesh and job name."""

    def __init__(self, jobs: Dict[Tuple[int, int], List[Dict]], workdir,
                 timeout: float = 300.0):
        import pickle
        from pathlib import Path
        from repro_torch.launch.mesh import RankGroup
        self.groups = {}
        for topo, js in jobs.items():
            # the jobs go through a file: a large argument written to a
            # spawned child's pipe would hold each start until the child
            # reads it
            path = Path(workdir) / f"jobs_{topo[0]}x{topo[1]}.pkl"
            with open(path, "wb") as f:
                pickle.dump(list(js), f)
            self.groups[topo] = RankGroup(
                _rank_main, topo[0] * topo[1], (tuple(topo), str(path)),
                timeout=timeout, label=f"mesh {tuple(topo)}")

    def results(self) -> Dict[Tuple[int, int], Dict]:
        try:
            return {topo: g.results()[0] for topo, g in self.groups.items()}
        finally:
            for g in self.groups.values():
                g.close()
