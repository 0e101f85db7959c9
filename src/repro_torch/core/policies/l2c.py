"""l2c: learned static layer subset replaced by linear approximations
(Learning-to-Cache, offline-calibrated mask).

The mask is static (calibrated offline via ``l2c_mask_from_deltas``), so
the policy carries no cache state at all: masked blocks are *replaced* by
their linear approximators every step, nothing is reused across steps.  The
mask is read to the host once, at construction, so the per-layer choice the
reference makes with ``lax.cond`` costs no sync.  A masked block is the
``linear_blend`` kernel at gamma = 1 (``apply_linear``'s result) on the
(B*N, D) view of its input.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.policies.base import CachePolicy, register
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.distributed.sharding import constrain

MaskLike = Union[torch.Tensor, np.ndarray]


def _host_bools(mask: MaskLike) -> List[bool]:
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return [bool(v) for v in np.asarray(mask, dtype=bool).reshape(-1)]


@register("l2c")
class LearnedLayerCache(CachePolicy):
    def __init__(self, model, fc, fc_params, *,
                 l2c_mask: Optional[MaskLike] = None, **kw):
        super().__init__(model, fc, fc_params, **kw)
        self.mask = ([False] * self.L if l2c_mask is None
                     else _host_bools(l2c_mask))
        if len(self.mask) != self.L:
            raise ValueError(f"l2c_mask has {len(self.mask)} entries; model "
                             f"has {self.L} layers")
        # the tensor-core copy of each W_l[l], single or split, made once
        # (None each off a bf16 model on CUDA)
        self.w_l_bf16 = self.map_copies(fc_params["W_l"])

    def init_state(self, batch: int) -> Dict:
        return {"stats": self.init_stats(batch)}

    def device_step(self, state, x_in, c, kind):
        fcp = self.fc_params
        x = x_in
        for lidx, bp in enumerate(self.model.blocks):
            if self.mask[lidx]:
                b, n, d = x.shape
                flat = x.reshape(b * n, d)
                x = linear_blend(flat, fcp["W_l"][lidx], fcp["b_l"][lidx],
                                 flat, gamma=1.0,
                                 w_bf16=self.w_l_bf16[lidx], gemm=self.gemm
                                 ).reshape(b, n, d)
            else:
                x = self.model.block_apply(bp, x, c)
            x = constrain(x, "act_batch", "act_seq", "act_embed")
        eps = self._eps(x, c)
        skipped = float(sum(self.mask))
        stats = state["stats"]
        stats["blocks_computed"].add_(self.L - skipped)
        stats["blocks_skipped"].add_(skipped)
        stats["motion_frac_sum"].add_(1.0)
        return eps


def l2c_mask_from_deltas(deltas: MaskLike, n_skip: int) -> torch.Tensor:
    """Learning-to-Cache proxy: skip the n layers whose outputs move the
    residual stream least (offline calibration).  (L,) -> (L,) bool, on
    ``deltas``' device; ties go to the lower layer (a stable sort, as
    ``jnp.argsort``)."""
    deltas = torch.as_tensor(deltas)
    order = torch.argsort(deltas, stable=True)
    mask = torch.zeros(deltas.shape, dtype=torch.bool, device=deltas.device)
    mask[order[:n_skip]] = True
    return mask
