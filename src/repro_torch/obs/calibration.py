"""Calibration recorder: per-layer per-step output deltas on a nocache run,
after the reference's ``obs/calibration.py``.

SmoothCache derives its layer schedule from the relative change of each
block's output across adjacent denoising steps of an *uncached* run, and
the audit plane's drift gauge compares measured cache error against the
same trajectory.  This module records it once and saves it as an ``.npz``
artifact in the reference's schema, so each package loads the other's
file:

- ``rel_delta``  (T, L, B)  per-step per-layer per-row relative Frobenius
  change of block outputs (step 0 is 1.0 by convention: no previous);
- ``errors_mean``  (L, T)  batch-mean, the matrix
  ``smooth_schedule_from_errors`` consumes;
- ``ts``  (T,)  the DDIM timestep of each recorded step;
- scalar metadata (num_steps, guidance_scale, layers, batch, policy).

Each step's (L * B_eff) Frobenius totals against the previous step's
outputs come from one ``saliency_delta`` launch over the (L * B_eff, N, D)
stack.  The deltas stay on the device and are read once, after the last
step.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.diffusion import schedule as sch

F32 = torch.float32
EPS = 1e-8

CALIBRATION_SCHEMA = ("rel_delta", "errors_mean", "ts")


def _block_outputs(impl, x_in: torch.Tensor, c: torch.Tensor):
    """(x_out, (L, B, N, D) block outputs) of one full forward: block l's
    output is block l+1's input, the last block's is the final output."""
    x_out, inputs = impl._full_forward(x_in, c)
    return x_out, torch.cat([inputs[1:], x_out[None]], dim=0)


@torch.no_grad()
def record_calibration(runner, *, batch: int,
                       labels: Optional[torch.Tensor] = None,
                       num_steps: int = 50, guidance_scale: float = 4.0,
                       num_train_steps: int = 1000, seed: int = 0,
                       x_init: Optional[torch.Tensor] = None) -> Dict:
    """Run ``num_steps`` of uncached DDIM sampling and record per-layer
    relative output deltas.  ``runner`` must be a nocache ``CachedDiT``: a
    caching policy would corrupt the measurement.  ``x_init`` (batch, H, W,
    C) gives the initial noise; otherwise it is drawn from a
    ``torch.Generator`` seeded with ``seed`` on the runner's device (the
    reference draws ``jax.random.normal(PRNGKey(seed))``, which the port
    cannot reproduce)."""
    if runner.policy != "nocache":
        raise ValueError(
            f"calibration must run uncached; got policy "
            f"{runner.policy!r} (build the runner with policy='nocache')")
    model, impl = runner.model, runner.impl
    dev = runner.device
    dit = model.cfg.dit
    img, ch = dit.image_size, dit.in_channels
    if labels is None:
        labels = torch.zeros((batch,), dtype=torch.int64, device=dev)
    labels = labels.to(dev)
    use_cfg = guidance_scale != 1.0
    null_label = dit.num_classes

    sched = sch.linear_schedule(num_train_steps, device=dev)
    ts = sch.ddim_timesteps(num_train_steps, num_steps, device=dev)
    ts_prev = torch.cat([ts[1:], torch.tensor([-1], dtype=ts.dtype,
                                              device=dev)])
    if x_init is not None:
        x = x_init.to(device=dev, dtype=F32)
    else:
        gen = torch.Generator(dev).manual_seed(seed)
        x = torch.randn((batch, img, img, ch), generator=gen, device=dev,
                        dtype=F32)
    b_eff = 2 * batch if use_cfg else batch
    lab_m = (torch.cat([labels, torch.full((batch,), null_label,
                                           dtype=labels.dtype, device=dev)])
             if use_cfg else labels)
    prev = None
    rels = []
    for i in range(num_steps):
        t = ts[i].expand(batch)
        t_prev = ts_prev[i].expand(batch)
        x_m = torch.cat([x, x]) if use_cfg else x
        t_m = torch.cat([t, t]) if use_cfg else t
        x_tok = model.tokens_in(x_m)
        c = model.conditioning(t_m, lab_m)
        x_out, outs = _block_outputs(impl, x_tok, c)
        if prev is None:            # step 0: no previous (forced to 1.0)
            prev = torch.zeros_like(outs)
        n_layers = outs.shape[0]
        flat = outs.reshape(n_layers * b_eff, *outs.shape[2:])
        _, diff, prevsq = saliency_delta(
            flat, prev.reshape(n_layers * b_eff, *outs.shape[2:]))
        rels.append((torch.sqrt(diff) / (torch.sqrt(prevsq) + EPS))
                    .reshape(n_layers, b_eff))
        eps_hat = impl._eps(x_out, c)
        if use_cfg:
            eps_c, eps_u = eps_hat.chunk(2, dim=0)
            eps_hat = eps_u + guidance_scale * (eps_c - eps_u)
        x = sch.ddim_step(sched, x, eps_hat, t, t_prev)
        prev = outs
    rel_delta = torch.stack(rels).cpu().numpy()   # (T, L, B_eff): one read
    rel_delta[0, :, :] = 1.0                      # no previous step
    errors_mean = rel_delta.mean(axis=2).T        # (L, T)
    return {
        "rel_delta": rel_delta.astype(np.float32),
        "errors_mean": errors_mean.astype(np.float32),
        "ts": ts.cpu().numpy().astype(np.int32)[:num_steps],
        "num_steps": np.int32(num_steps),
        "guidance_scale": np.float32(guidance_scale),
        "layers": np.int32(runner.L),
        "batch": np.int32(b_eff),
        "policy": np.str_(runner.policy),
    }


def save_calibration(path: str, result: Dict) -> None:
    for key in CALIBRATION_SCHEMA:
        if key not in result:
            raise ValueError(f"calibration result missing {key!r}")
    np.savez(path, **result)


def load_calibration(path: str) -> Dict:
    with np.load(path, allow_pickle=False) as f:
        out = {k: f[k] for k in f.files}
    for key in CALIBRATION_SCHEMA:
        if key not in out:
            raise ValueError(f"{path} is not a calibration artifact "
                             f"(missing {key!r})")
    L, T = int(out["layers"]), int(out["num_steps"])
    if out["errors_mean"].shape != (L, T):
        raise ValueError(
            f"errors_mean shape {out['errors_mean'].shape} != ({L}, {T})")
    return out
