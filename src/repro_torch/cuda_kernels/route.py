"""Which kernel a CUDA call of a two-route wrapper launches.

``linear_blend`` and ``fused_gate`` have three routes on the card
(``csrc/linear_blend.cu``, ``csrc/fused_gate.cu``), by ``gemm_route``:

- ``"wgmma"``: bf16 X against a bf16 copy of W on the tensor cores (wgmma
  fed by TMA, ``csrc/tc_gemm.cuh``).  TMA needs 16-byte row strides and
  16-byte aligned bases, and the epilogue stores column pairs, so it takes
  bf16 inputs with D % 8 == 0 and F % 8 == 0 whose every base is 16-byte
  aligned.  It multiplies the caller's tensor-core copy of W (``w_bf16=``,
  ``check_w_bf16`` raises without one): for the identity maps, which bf16
  holds exactly, one bf16 copy.
- ``"wgmma_split"``: the same kernel and the same rule, for a call whose
  copy is split (``is_split``: its row count): W as SPLIT_TERMS bf16 terms,
  W_hi = bf16(W), W_mid = bf16(W - W_hi) and W_lo = bf16(W - W_hi -
  W_mid), stacked along K (``check_w_split``;
  ``core/linear_approx.py:split_copies``).  Their products with X miss X W
  by at most 2^-24 of |X| |W|, where one bf16 copy misses it by 2^-8.  Two
  terms (2^-16) left the fitted bypass at up to 8.6e-4 rel-L2 on the card,
  with outputs near 0 off by more than bf16's 2e-2, so there are three.
  The runners hand maps handed in, such as fitted ones, these copies.
- ``"simt"``: the f32 FMA kernels, for everything else (f32 inputs are held
  to 1e-4, which bf16 operands do not meet; ragged bf16 shapes), and for a
  call that names it (``gemm="simt"``), which multiplies the f32 W.

``linear_blend`` has a fourth, ``"gemv"``: a call of M <= GEMV_MAX_ROWS
rows (``gemm_route(..., m=M)``; the decode gate's M = batch) that the
wgmma rule takes with a single bf16 copy goes to a split-K kernel over
every SM (``gemv_plan``), where the wgmma route's 128-row tile would be
nearly all padding and its ceil(F / 192) blocks would leave most SMs idle.
GEMV_MAX_ROWS is the card's crossover against the wgmma route (PERF.md).
A split copy stays on ``"wgmma_split"`` at any M: no caller brings one at
such M on a served path.  ``fused_gate`` does not take the gemv route.

``knn_density`` and ``merge_assign`` have two routes too
(``csrc/knn_density.cu``, ``csrc/token_merge.cu``), by ``window_route``:

- ``"mma"``: bf16 windows on the tensor cores (``mma.sync``), each window
  bulk-copied into shared memory once and left there
  (``csrc/window_mma.cuh``).  The bulk copy needs 16-byte aligned bases and
  row lengths, and the window, its rows padded, has to fit in shared
  memory, so it takes bf16 ``h`` with w <= 32, D % 8 == 0 and every base
  16-byte aligned, whose ``window_smem_bytes`` fit.
- ``"simt"``: the f32 FMA kernels, for everything else (f32 ``h``, ragged
  D, unaligned bases).

``saliency_delta`` has two routes (``csrc/saliency_delta.cu``), by
``saliency_route``:

- ``"onepass"``: one launch of SAL_GROUPS blocks per sample, each reducing
  its rows with 16-byte loads and a share of the totals' tree, the last
  block of a sample (an integer ticket) adding the sample's partials.  The
  16-byte loads need 16-byte aligned bases and rows of a multiple of 16
  bytes (``onepass_takes``: f32 or bf16 with D * esize % 16 == 0 at
  16-byte aligned bases).  Its warps walk ceil(N / 256) rows each, one
  after another, so it is picked up to N = SAL_MAX_ONEPASS_ROWS (a row a
  warp, the served calls); at N = 1024 the SIMT route's grid of a warp
  per row was faster on the card (PERF.md §6).
- ``"simt"``: the two-launch kernel, for everything else (longer N, ragged
  rows, unaligned bases).  On every input the onepass kernel takes, the
  two give the same bits.

Each rule is a pure function of dtype, shape and alignment, so a call's
route is known before it launches and the tests can check it on the CPU.
A route that fails to build or launch raises; nothing falls back to the
other route or to the plain version.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Optional

import torch

WGMMA = "wgmma"
WGMMA_SPLIT = "wgmma_split"
SIMT = "simt"
MMA = "mma"
ONEPASS = "onepass"
GEMV = "gemv"
ROUTES = (WGMMA, WGMMA_SPLIT, SIMT)   # linear_blend, fused_gate
BLEND_ROUTES = ROUTES + (GEMV,)       # linear_blend
TC_CHUNK = 64                 # rows of K a wgmma stage holds (tc_gemm.cuh)
SPLIT_TERMS = 3               # bf16 terms of a split copy: hi, mid, lo
WINDOW_ROUTES = (MMA, SIMT)   # knn_density, merge_assign
SAL_ROUTES = (ONEPASS, SIMT)  # saliency_delta
ALIGN = 16                    # bytes: TMA's and bulk copies' alignment
MAX_WINDOW = 32               # tokens: the window kernels' kMaxW
SMEM_LIMIT = 232_448          # bytes of shared memory a block may opt into
WINDOW_EXTRA_BYTES = 34_320   # window_mma.cuh kExtraBytes: Gram partials,
                              # scratch, the mbarrier
SAL_GROUPS = 32               # saliency_delta.cu kGroups: blocks per sample
SAL_TOTAL_THREADS = 256       # ... kTotalThreads: the totals' slots
SAL_MAX_ONEPASS_ROWS = 256    # the longest N the onepass route is picked for
GEMV_MAX_ROWS = 4             # the most rows the gemv route is picked for
GEMV_COLS = 256               # linear_blend.cu kGvCols: columns a tile
GEMV_ROWS = 4                 # ... kGvRows: rows a row group
GEMV_LANES = 8                # ... kGvLanes: K lanes a block
GEMV_MAX_K = 2048             # ... kGvMaxK: K rows a split at most
GEMV_MIN_K = 64               # K rows a split at least (8 a lane)
GEMV_SMS = 132                # the H100's SMs
GEMV_BLOCKS = 2 * GEMV_SMS    # blocks the tiles and splits aim at: two an SM
GEMV_MAX_TICKETS = 65536      # ... kGvMaxTickets: tiles x row groups


def gemm_route(dtype: torch.dtype, d: int, f: int,
               addresses: Iterable[int],
               w_bf16: Optional[torch.Tensor] = None,
               m: Optional[int] = None) -> str:
    """The route of a (M, D) x (D, F) call with inputs of ``dtype`` whose
    base addresses are ``addresses``, bringing ``w_bf16``, its tensor-core
    copy of W: wgmma_split for a split copy, else, where the tensor cores
    take the call, gemv for M <= GEMV_MAX_ROWS (``m`` given: linear_blend's
    calls) and wgmma above."""
    if (dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and all(a % ALIGN == 0 for a in addresses)):
        if is_split(w_bf16, d):
            return WGMMA_SPLIT
        return GEMV if m is not None and 1 <= m <= GEMV_MAX_ROWS else WGMMA
    return SIMT


class GemvPlan(NamedTuple):
    """The gemv route's grid for a (M, D) x (D, F) call: ``tiles`` column
    tiles of GEMV_COLS, ``splits`` splits of K of ``k_rows`` rows each (the
    last one the rest), ``groups`` row groups of GEMV_ROWS; block (tile,
    split, group) sums lane l's rows k0 + l, k0 + l + GEMV_LANES, ... in
    order, then the lanes in order, and the last block of a (tile, group)
    the splits in order."""
    tiles: int
    splits: int
    k_rows: int
    groups: int

    @property
    def workspace(self) -> int:
        """f32 values of the partials' workspace."""
        return (self.groups * self.tiles * self.splits * GEMV_ROWS
                * GEMV_COLS)


def gemv_plan(m: int, d: int, f: int,
              blocks: Optional[int] = None) -> GemvPlan:
    """The gemv route's split of K: as many splits as bring tiles x splits
    up to GEMV_BLOCKS, none under GEMV_MIN_K rows nor over GEMV_MAX_K, each
    a whole number of GEMV_LANES rows; where that would put a second block
    on fewer than half the SMs, one block an SM instead (at D = F = 1536,
    M = 4, 132 blocks took 0.00574 ms and 144 0.00671 on an NVIDIA H100
    80GB HBM3 at 700 W: ``chip_smoke.py`` gemv_crossover, PERF.md).
    ``blocks`` aims tiles x splits at that many blocks instead, with no
    such correction (the plans ``chip_smoke.py`` times beside this one)."""
    tiles = -(-f // GEMV_COLS)
    want = max(1, min((blocks or GEMV_BLOCKS) // tiles, d // GEMV_MIN_K))
    if blocks is None and GEMV_SMS < tiles * want < GEMV_SMS * 3 // 2:
        want = max(1, GEMV_SMS // tiles)
    want = max(want, -(-d // GEMV_MAX_K))
    k_rows = -(-d // want)
    k_rows = -(-k_rows // GEMV_LANES) * GEMV_LANES
    return GemvPlan(tiles, -(-d // k_rows), k_rows, -(-m // GEMV_ROWS))


def split_rows(d: int) -> int:
    """Rows of each term of a split copy of a (D, F) map: D padded to whole
    K chunks, so each term's first row starts a chunk."""
    return -(-d // TC_CHUNK) * TC_CHUNK


def is_split(w_bf16: Optional[torch.Tensor], d: int) -> bool:
    """Whether ``w_bf16`` is a split copy of a map of D rows, by its row
    count: SPLIT_TERMS * split_rows(D), where a single copy has D."""
    return (w_bf16 is not None and w_bf16.dim() == 2
            and w_bf16.shape[0] == SPLIT_TERMS * split_rows(d))


def window_pitch(d: int) -> int:
    """Bytes between two rows of a window in shared memory on the mma route:
    an odd number of 16-byte units, one or two of them padding
    (``window_mma.cuh:pitch_bytes``)."""
    return ((d // 8 + 1) | 1) * 16


def window_smem_bytes(w: int, d: int) -> int:
    """Shared memory of one window's block on the mma route."""
    return w * window_pitch(d) + WINDOW_EXTRA_BYTES


def window_route(dtype: torch.dtype, w: int, d: int,
                 addresses: Iterable[int]) -> str:
    """The route of a call on (W, w, d) windows of ``dtype`` whose base
    addresses are ``addresses`` (``h``'s: the outputs are fresh, so
    aligned)."""
    if (dtype == torch.bfloat16 and 1 <= w <= MAX_WINDOW and d > 0
            and d % 8 == 0 and all(a % ALIGN == 0 for a in addresses)
            and window_smem_bytes(w, d) <= SMEM_LIMIT):
        return MMA
    return SIMT


class SaliencyPlan(NamedTuple):
    """The onepass route's split of a sample's N rows: ``groups`` blocks,
    block j owning the rows r = j (mod groups), at most ``block_rows`` of
    them; each of its SAL_TOTAL_THREADS / groups warps takes the rows of
    one slot of the totals (r = t (mod SAL_TOTAL_THREADS)), at most
    ``warp_rows``, one after another."""
    groups: int
    block_rows: int
    warp_rows: int


def saliency_plan(n: int) -> SaliencyPlan:
    return SaliencyPlan(SAL_GROUPS, -(-n // SAL_GROUPS),
                        -(-n // SAL_TOTAL_THREADS))


def onepass_takes(dtype: torch.dtype, n: int, d: int,
                  addresses: Iterable[int]) -> bool:
    """Whether the onepass kernel can run (B, N, D) inputs of ``dtype``
    whose base addresses are ``addresses`` (x's and x_prev's)."""
    esize = {torch.float32: 4, torch.bfloat16: 2}.get(dtype)
    return (esize is not None and n > 0 and d > 0
            and d * esize % ALIGN == 0
            and all(a % ALIGN == 0 for a in addresses))


def saliency_route(dtype: torch.dtype, n: int, d: int,
                   addresses: Iterable[int]) -> str:
    """The route of a call on such inputs."""
    if n <= SAL_MAX_ONEPASS_ROWS and onepass_takes(dtype, n, d, addresses):
        return ONEPASS
    return SIMT


def check_w_bf16(w_bf16: Optional[torch.Tensor], w: torch.Tensor) -> None:
    """The bf16 copy of ``w`` that the wgmma route multiplies: given, same
    shape and device, contiguous, 16-byte aligned.  That it holds ``w``
    rounded to bf16 is the caller's contract (fastcache and l2c make it
    once, at construction, ``linear_approx.bf16_copies``); no call converts
    ``w`` itself."""
    if w_bf16 is None:
        raise ValueError("the wgmma route needs w_bf16= (w in bfloat16, "
                         "made once by the caller)")
    if (w_bf16.dtype != torch.bfloat16 or w_bf16.shape != w.shape
            or w_bf16.device != w.device):
        raise ValueError(f"w_bf16 must be {tuple(w.shape)} bfloat16 on "
                         f"{w.device}, got {tuple(w_bf16.shape)} "
                         f"{w_bf16.dtype} on {w_bf16.device}")
    if not w_bf16.is_contiguous() or w_bf16.data_ptr() % ALIGN:
        raise ValueError("w_bf16 must be contiguous and 16-byte aligned")


def check_w_split(w_bf16: Optional[torch.Tensor], w: torch.Tensor) -> None:
    """The split copy of ``w`` (D, F) that the wgmma_split route
    multiplies: given, (SPLIT_TERMS * split_rows(D), F) bfloat16 on ``w``'s
    device, contiguous, 16-byte aligned.  That its rows hold the terms,
    each followed by zero rows up to split_rows(D), is the caller's
    contract (``linear_approx.split_copies``, made once, at construction);
    no call converts ``w`` itself."""
    if w_bf16 is None:
        raise ValueError("the wgmma_split route needs w_bf16= (w split "
                         "into bfloat16 terms, made once by the caller)")
    d, f = w.shape
    shape = (SPLIT_TERMS * split_rows(d), f)
    if (w_bf16.dtype != torch.bfloat16 or tuple(w_bf16.shape) != shape
            or w_bf16.device != w.device):
        raise ValueError(f"a split w_bf16 must be {shape} bfloat16 on "
                         f"{w.device}, got {tuple(w_bf16.shape)} "
                         f"{w_bf16.dtype} on {w_bf16.device}")
    if not w_bf16.is_contiguous() or w_bf16.data_ptr() % ALIGN:
        raise ValueError("a split w_bf16 must be contiguous and 16-byte "
                         "aligned")
