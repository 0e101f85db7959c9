"""Train-step factory + host training loop, after the reference's
``training/loop.py``.

The reference's ``train_step(params, opt_state, batch)`` is a pure function
of a parameter tree whose block parameters are stacked on the layer axis.
The port's models hold one tensor per layer, so ``param_tree`` first lays
each block parameter out as one (L, ...) tensor whose rows are the
per-layer parameters' storage: the tree and the model share memory, and
the optimizer's in-place update of a leaf is the model's.  Gradients are
laid out the same way (``make_train_step`` binds one zeroed (L, ...)
buffer per leaf, its rows as the per-layer ``.grad``, so autograd
accumulates into the stacked leaf).

A step makes no host sync: the learning rate and the optimizer's step
count are host numbers, clipping stays on the device, and ``train`` reads
the metrics back only at its log steps.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.bridge import LayerStack, param_groups
from repro_torch.training.optimizer import clip_by_global_norm


def param_tree(model) -> Dict:
    """The model's parameters as the reference's tree, each block
    parameter one (L, ...) leaf that the per-layer parameters are rows of
    (their storage moves into it; values unchanged).  Call once per model:
    a second call lays the parameters out anew, and the first tree no
    longer holds them."""
    def lay_out(g):
        if isinstance(g, LayerStack):
            stack = torch.stack([p.detach() for p in g.tensors])
            for row, p in zip(stack, g.tensors):
                p.data = row
            return stack
        return g.detach()
    return tree.map(lay_out, param_groups(model))


def grad_tree(model) -> Dict:
    """Zeroed gradient buffers in the reference's tree, bound as the
    model's ``.grad`` (rows of a stacked leaf for the per-layer
    parameters), with gradients turned on for every parameter."""
    groups = param_groups(model)

    def bind(g):
        ts = g.tensors if isinstance(g, LayerStack) else [g]
        buf = torch.zeros((len(ts),) + tuple(ts[0].shape),
                          dtype=ts[0].dtype, device=ts[0].device)
        for row, p in zip(buf, ts):
            p.requires_grad_(True)
            p.grad = row
        return buf if isinstance(g, LayerStack) else buf[0]
    return tree.map(bind, groups)


def make_train_step(model, opt, lr_fn: Callable, max_grad_norm: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for ``params = param_tree(model)``; the metrics are
    ``loss``, ``grad_norm``, ``lr`` and the model's scalar metrics, as
    device scalars (``lr`` a host float).  The step's gradient tree is
    ``train_step.grads``.  ``events``, four ``torch.cuda.Event``s, are
    recorded at the step's start and after its forward, backward and
    update (clipping included), for timing the three on the card."""
    grads = grad_tree(model)

    def train_step(params, opt_state, batch, events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        torch._foreach_zero_(tree.leaves(grads))
        loss, metrics = model.loss(batch)
        mark(1)
        loss.backward()
        mark(2)
        _, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(opt_state.step)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        mark(3)
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        out.update({k: v.detach() for k, v in metrics.items()
                    if v.ndim == 0})
        return params, opt_state, out

    train_step.grads = grads
    return train_step


def host_metrics(metrics: Dict) -> Dict[str, float]:
    """The metrics as floats, the device scalars in one read."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    vals = (torch.stack([metrics[k].float() for k in keys]).tolist()
            if keys else [])
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


def train(model, params, opt, lr_fn, data_iter, *, steps: int,
          log_every: int = 10, max_grad_norm: float = 1.0,
          callback: Optional[Callable[[int, Dict], None]] = None):
    """Host loop: ``steps`` train steps on ``next(data_iter)`` batches,
    the metrics read back at every ``log_every``-th step and the last.
    ``params`` is ``param_tree(model)``.  Returns (params, opt_state,
    history)."""
    step_fn = make_train_step(model, opt, lr_fn, max_grad_norm)
    opt_state = opt.init(params)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = host_metrics(metrics)
            m["step"] = i
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(i, m)
    return params, opt_state, history
