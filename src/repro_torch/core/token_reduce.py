"""TokenReducer: the serving-path token-compression stage (CTM, Eqs. 10-13),
after the reference's ``core/token_reduce.py``.

One reducer sits between ``tokens_in`` and the cache policy inside
``CachedDiT.step``: per sample and per step it scores tokens (kNN density x
temporal motion), merges each fixed window of ``w`` tokens down to a static
M = ceil(r * w) cluster centers (``core/token_merge.py``), hands the policy
the reduced (B, M_total, D) grid, and unmerges the final hidden back to full
resolution inside the policy's ``_eps`` — so a cache policy composes with
token compression without knowing it exists.

M is fixed at construction from (window, keep_ratio), so the reduced grid
never changes shape across steps, samples or admissions.  A ratio whose
ceil fills the window deactivates the reducer (``active == False``; the
runner then drops it and the step is bitwise merge-off).  No shape depends
on data and nothing is read back to the host.

Per-sample state: the previous step's full-resolution tokens (the temporal
term of Eq. 12) ride the policy state under the reserved ``tokred`` key —
(B, N, D) plus a (B,) warm flag — so engine admissions reset them per slot
like any cache payload.  A cold row scores against itself (zero motion),
keeping every row's merge independent of its batchmates.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import token_merge
from repro_torch.cuda_kernels.ref import check_knn_k
from repro_torch.models.dit import DiTModel

# the reserved key the reducer's rows ride under in the policy state
STATE_KEY = "tokred"


class TokenReducer:
    def __init__(self, model: DiTModel, fc):
        self.window = int(fc.merge_window)
        self.keep_ratio = float(fc.merge_ratio)
        self.k = int(fc.knn_k)
        self.lam = float(fc.merge_lambda)
        self.n_tokens = model.num_tokens
        self.d_model = model.cfg.d_model
        self.dtype = model.dtype
        self.device = model.device
        if self.window < 2:
            raise ValueError(f"merge_window must be >= 2, got {self.window}")
        self.m = token_merge.keep_count(self.window, self.keep_ratio)
        # a ratio whose ceil hits the full window keeps every token: the
        # stage is statically inert and the runner drops the reducer
        self.active = self.m < self.window
        if self.active:
            if self.n_tokens % self.window != 0:
                raise ValueError(
                    f"token count {self.n_tokens} must be divisible by the "
                    f"merge window {self.window}")
            check_knn_k(self.k, self.window)
        self.n_windows = self.n_tokens // self.window
        self.reduced_tokens = (self.n_windows * self.m if self.active
                               else self.n_tokens)
        # this step's MergeMap, set by reduce() and cleared by the runner
        self._mm: Optional[token_merge.MergeMap] = None

    # -- per-sample state (rides the policy state under STATE_KEY) -------

    def init_rows(self, batch: int) -> Dict[str, torch.Tensor]:
        return {
            "prev_full": torch.zeros((batch, self.n_tokens, self.d_model),
                                     dtype=self.dtype, device=self.device),
            "have_prev": torch.zeros((batch,), dtype=torch.bool,
                                     device=self.device),
        }

    def reset_rows(self, tr: Dict[str, torch.Tensor], rows: Sequence[int]
                   ) -> Dict[str, torch.Tensor]:
        """Re-arm sample rows in place.  fill_ on row views: assigning a
        Python scalar to a 0-dim CUDA view synchronizes."""
        for r in rows:
            tr["prev_full"][r].fill_(0.0)
            tr["have_prev"][r].fill_(False)
        return tr

    @staticmethod
    def snapshot_rows(tr: Dict[str, torch.Tensor], idx: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Copy the rows ``idx`` (an int64 index tensor on the rows' device)
        out of the reducer's state: the previous step's full-resolution
        tokens and the warm flag, so a preempted merged request resumes its
        merge bookkeeping where it stopped.  Every leaf is batch-leading."""
        return {k: v.index_select(0, idx) for k, v in tr.items()}

    @staticmethod
    def restore_rows(tr: Dict[str, torch.Tensor],
                     snap: Dict[str, torch.Tensor], idx: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
        """Write a ``snapshot_rows`` copy into rows ``idx``, in place."""
        for k, v in tr.items():
            v.index_copy_(0, idx, snap[k])
        return tr

    # -- the stage -------------------------------------------------------

    def reduce(self, x_full: torch.Tensor, tr: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        """(B, N, D) full-resolution tokens -> (B, M_total, D) merged grid;
        the reducer rows ``tr`` are updated in place (this step's tokens
        become the next one's reference).  The MergeMap is kept on the
        reducer for this step only: ``unmerge`` (called from the policy's
        ``_eps`` later in the same step) reads it, and the runner clears it
        when the step returns."""
        prev = torch.where(tr["have_prev"][:, None, None],
                           tr["prev_full"].to(x_full.dtype), x_full)
        merged, mm = token_merge.merge_tokens(
            x_full, prev, window=self.window, keep_ratio=self.keep_ratio,
            k=self.k, lam=self.lam)
        self._mm = mm
        tr["prev_full"].copy_(x_full)
        tr["have_prev"].fill_(True)
        return merged

    def unmerge(self, hidden: torch.Tensor) -> torch.Tensor:
        """(B, M_total, D) reduced hidden -> (B, N, D) through this step's
        assignment (Alg. 2's M mapping)."""
        if self._mm is None:
            raise RuntimeError("TokenReducer.unmerge called outside a "
                               "reduce()d step (no MergeMap stashed)")
        return token_merge.unmerge_tokens(
            hidden, self._mm, window=self.window, n_tokens=self.n_tokens)
