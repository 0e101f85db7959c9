"""Shadow-compute audit plane: online cached-vs-true error measurement,
after the reference's ``obs/audit.py``.

The paper's headline theoretical claim is a bounded approximation error
under the chi^2 decision rule; this module measures that error while the
cache is serving.  On a deterministic seeded schedule (``audit_mask``,
computed on the host from the engine's model-step counter) the serve step
also runs the full uncached forward on the same inputs and accumulates:

- **end-to-end error**: per-slot relative eps error after the identical
  CFG/guidance blend (``sampler.denoise_step`` with its model evaluation
  routed through ``CachedDiT.audit_eval``), into the ``audit_rel_err``
  histogram and the per-slot / per-request accumulators;
- **per-layer error**: when the policy exposes its hidden stack
  (``CachePolicy.audit_hidden``; fastcache's ``prev_hidden``), the
  relative error of every entry of the cached stack against the true one,
  into the metrics' ``audit`` group.  Its sums come from one
  ``saliency_delta`` launch over the ((L+1) * B_eff, N, D) stacks;
- **bound violations**: audited rows whose measured error exceeds the
  policy's ``predicted_error_bound()`` (Eq. 9 for fastcache) bump
  ``bound_violations_total``;
- **per-request error budget**: ``audit_err_sum / audit_err_sq_sum /
  audit_steps / audit_violations`` ride the engine's per-slot ``slot_acc``
  accumulators, zeroed at admission and harvested into ``req.cache``.

Where the reference wraps the audit in a ``lax.cond`` on a traced flag,
the port branches on the host-side flag with a plain ``if``: the flag is a
Python bool already, so no value is read from the device, and steps that
are not audited run none of the shadow forward.  Nothing here reads a
device value on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.diffusion import sampler
from repro_torch.obs import metrics as obs_metrics

F32 = torch.float32

# 1/32 of serve steps (the reference's default)
DEFAULT_AUDIT_FRACTION = 1.0 / 32.0

# per-request error-budget keys that ride the engine's slot_acc
# (zeroed at admission, harvested into req.cache at finish)
ACC_ERR_SUM = "audit_err_sum"
ACC_ERR_SQ = "audit_err_sq_sum"
ACC_STEPS = "audit_steps"
ACC_VIOLATIONS = "audit_violations"
AUDIT_ACC_KEYS = (ACC_ERR_SUM, ACC_ERR_SQ, ACC_STEPS, ACC_VIOLATIONS)

_MASK64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64(z: int) -> int:
    """SplitMix64 finalizer: a cheap, well-mixed 64-bit hash (the
    reference's, bit for bit)."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def audit_mask(step: int, fraction: float, seed: int = 0) -> bool:
    """Deterministic stratified audit schedule: the step counter is cut
    into windows of ``round(1/fraction)`` steps and exactly one hashed
    offset per window is audited, so the realized rate is the nominal one
    over any horizon.  Host-side Python, equal to the reference's for every
    (step, fraction, seed)."""
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    period = max(2, round(1.0 / fraction))
    window, offset = divmod(int(step), period)
    h = _splitmix64((window << 17) ^ (int(seed) * 0x5851F42D4C957F2D
                                      & _MASK64))
    return offset == h % period


def rel_err_rows(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Per-row relative Frobenius error ||a - b|| / ||b||, reducing every
    axis but the leading one.  ``b`` is the reference (the true forward)."""
    dims = tuple(range(1, b.ndim))
    d = a.to(F32) - b.to(F32)
    bf = b.to(F32)
    num = (d * d).sum(dim=dims)
    den = (bf * bf).sum(dim=dims)
    return torch.sqrt(num / den.clamp(min=eps))


def layer_rel_err(cached: torch.Tensor, true: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Per-layer per-row relative Frobenius error for (L+1, B, N, D) hidden
    stacks -> (L+1, B): ||cached - true||^2 and ||true||^2 of every row are
    the totals of one ``saliency_delta`` call with x = cached and
    prev = true."""
    l1, b = cached.shape[:2]
    flat = cached.shape[2:]
    _, num, den = saliency_delta(cached.reshape(l1 * b, *flat).contiguous(),
                                 true.reshape(l1 * b, *flat).contiguous())
    return torch.sqrt(num / den.clamp(min=eps)).reshape(l1, b)


def apply_audit(runner, sched, state: Dict, x: torch.Tensor,
                t: torch.Tensor, t_prev: torch.Tensor, labels: torch.Tensor,
                guidance, active: torch.Tensor, eps_cached: torch.Tensor,
                cfg_rows: bool, bound: Optional[float], metrics: Dict,
                slot_acc: Dict[str, torch.Tensor], audit_flag: bool,
                ranges: bool = False) -> None:
    """One audit decision of a serve step.  When ``audit_flag`` (the host's
    schedule bit) is set, run the shadow full forward on the same pre-step
    latents ``x`` and fold cached-vs-true errors into ``metrics`` and the
    per-slot ``slot_acc``, both in place; otherwise do nothing.

    ``state`` is the post-step policy state (read only: the hidden stack
    the cached path just produced), ``eps_cached`` the post-blend eps the
    cached path fed its DDIM update, ``bound`` the policy's claimed
    per-step relative error bound (None = no claim, never violates)."""
    if not audit_flag:
        return
    bound_val = float("inf") if bound is None else float(bound)
    hidden_box = []

    def shadow_eval(st, lat, t_in, lab):
        eps_true, hid = runner.audit_eval(lat, t_in, lab)
        hidden_box.append(hid)
        return eps_true, st

    _, _, eps_true = sampler.denoise_step(
        runner, sched, {}, x, t, t_prev, labels, guidance_scale=guidance,
        model_eval=shadow_eval, return_eps=True, ranges=ranges)

    act = active.to(F32)                            # (S,)
    err = rel_err_rows(eps_cached, eps_true) * act  # (S,)
    viol = ((err > bound_val) & active).to(F32)

    obs_metrics.inc(metrics, obs_metrics.AUDIT_STEPS, 1.0)
    obs_metrics.inc(metrics, obs_metrics.AUDIT_SLOT_STEPS, act.sum())
    obs_metrics.inc(metrics, obs_metrics.BOUND_VIOLATIONS, viol.sum())
    obs_metrics.observe_many(metrics, obs_metrics.AUDIT_REL_ERR, err, act)
    obs_metrics.slot_add(metrics, obs_metrics.SLOT_AUDIT_ERR, err)
    obs_metrics.slot_add(metrics, obs_metrics.SLOT_AUDIT_STEPS, act)

    hid_cached = runner.audit_hidden(state)
    if hid_cached is not None:      # None: the policy caches no hidden stack
        act_rows = torch.cat([act, act]) if cfg_rows else act
        lerr = layer_rel_err(hid_cached, hidden_box[0])   # (L+1, B_eff)
        grp = metrics["audit"]
        grp["layer_err_sum"].add_((lerr * act_rows[None]).sum(dim=1))
        grp["layer_rows"].add_(act_rows.sum())

    slot_acc[ACC_ERR_SUM].add_(err)
    slot_acc[ACC_ERR_SQ].add_(err * err)
    slot_acc[ACC_STEPS].add_(act)
    slot_acc[ACC_VIOLATIONS].add_(viol)


# --------------------------------------------------------------------------
# Host-side reporting (--audit-out)
# --------------------------------------------------------------------------


def request_budget(cache: Dict) -> Dict[str, float]:
    """Summarize one finished request's harvested error budget (the
    ``AUDIT_ACC_KEYS`` the engine copied into ``req.cache``)."""
    steps = float(cache.get(ACC_STEPS, 0.0))
    err_sum = float(cache.get(ACC_ERR_SUM, 0.0))
    err_sq = float(cache.get(ACC_ERR_SQ, 0.0))
    mean = err_sum / steps if steps > 0 else 0.0
    var = max(err_sq / steps - mean * mean, 0.0) if steps > 0 else 0.0
    return {
        "audited_steps": steps,
        "err_sum": err_sum,
        "err_mean": mean,
        "err_std": var ** 0.5,
        "violations": float(cache.get(ACC_VIOLATIONS, 0.0)),
    }


def audit_report(finished, *, fraction: float,
                 bound: Optional[float] = None,
                 collector=None) -> Dict:
    """The ``--audit-out`` JSON document: per-request error budgets plus
    the collector's latest windowed drift/burn summary (when a collector
    with harvested audit metrics is supplied)."""
    requests = []
    for r in finished:
        row = {"rid": r.rid}
        row.update(request_budget(r.cache or {}))
        requests.append(row)
    doc = {
        "audit_fraction": fraction,
        "predicted_bound": bound,
        "requests": requests,
        "violations_total": sum(r["violations"] for r in requests),
    }
    if collector is not None and collector.windows:
        last = collector.windows[-1]
        if "audit" in last:
            doc["window"] = last["audit"]
    return doc
