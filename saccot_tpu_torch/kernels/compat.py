"""Compatibility degrees: CUDA kernel wrappers and their plain PyTorch version.

Three TPU kernels are replaced, and `degrees` routes between them as
`saccot_tpu/kernels/compat.py::degrees_pallas` does:
  - `_degree_kernel_mxu` (two-sided) by `csrc/compat_degrees.cu`;
  - `_degree_kernel` (the direct form, `mxu=False`) by the same
    `csrc/compat_degrees.cu`: it already differences coordinates directly and
    tests i != j on `row_offset + i`, so the TPU's split-bf16 Gram (a
    TPU-only trick) and the direct form collapse into one CUDA kernel. Its
    launches are counted apart (`compat_degrees_direct`);
  - `_degree_kernel_mxu_tri` (symmetric: the rows are the columns, row offset
    0, one mask for both, R > `TRI_MIN_ROWS`) by `csrc/compat_degrees_tri.cu`,
    which evaluates each unordered pair once.
`degree_plan` decides how the two-sided kernel's grid covers (batch, R, C)
on a card of a given SM count; the ring step (`kernels/ring_compat.py`) and
the two-sided timing variants (`kernels/compat_ops.py`) take the same plan.
For CUDA tensors `degrees` launches a kernel; for CPU tensors it runs
`degrees_reference` (the blocked plain version, `engine/compat.degrees`, the
plain version of every route). It never falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np
import torch

from saccot_tpu_torch.engine import compat as compat_mod
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import (
    f32_points, optional_mask, ptr, sm_count, stream_of, tickets,
)
from saccot_tpu_torch.utils import debug
from saccot_tpu_torch.utils.params import SacCotParams


def degrees_reference(
    P_rows: torch.Tensor,
    Q_rows: torch.Tensor,
    P_cols: torch.Tensor,
    Q_cols: torch.Tensor,
    params: SacCotParams,
    row_offset: int = 0,
    mask_rows: Optional[torch.Tensor] = None,
    mask_cols: Optional[torch.Tensor] = None,
    mxu: Optional[bool] = None,
) -> torch.Tensor:
    """The plain version of every route of `degrees` (`engine.compat.degrees`);
    `mxu` picks a kernel, so it changes nothing here."""
    return compat_mod.degrees(P_rows, Q_rows, P_cols, Q_cols, params, row_offset=row_offset,
                              mask_rows=mask_rows, mask_cols=mask_cols)


# The two-sided loop's block (csrc/degree_loops.cuh kThreads) and its rows a
# thread (kRowsWide, kRowsNarrow). Each row is summed over SEGMENT columns at
# a time (kSegment), then segment by segment, so a split is a whole number of
# segments.
THREADS = 128
ROWS_PER_THREAD = (2, 1)
SEGMENT = 256
# A grid of FULL_BLOCKS_PER_SM blocks a SM fills the card: at the loop's 52-56
# registers 9 blocks of 128 threads are resident a SM, so 64 a SM is 7 waves
# and the last wave idles at most a seventh of the card. Below that the loop
# splits its columns into single segments. Measured on an H100 at the ring
# step, the SP slice, the bench point and one pair at N=50,000
# (`scripts/exp_degree_plan.py`): each shape was fastest at one segment a
# block or within 3% of it, with 2 rows a thread where that still gives
# FULL_BLOCKS_PER_SM blocks a SM and 1 row where it does not.
FULL_BLOCKS_PER_SM = 64
# A split plan keeps one partial sum a (row, segment) in device memory,
# 4 * batch * segments * R bytes (78 MB for the two-sided call on the kitti
# pair); past SCRATCH_BYTES the loop runs unsplit, to the same bits.
SCRATCH_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class DegreePlan:
    """Grid of the two-sided degree loop: (tiles, splits, batch) blocks of
    THREADS threads, `rows` rows a thread; split s sums the column segments
    `split_segments(s)`."""
    batch: int
    rows: int
    tiles: int
    splits: int
    segments: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits * self.batch

    def split_segments(self, s: int) -> Tuple[int, int]:
        """Split s's segments [lo, hi), as the kernel computes them."""
        return s * self.segments // self.splits, (s + 1) * self.segments // self.splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def degree_plan(batch: int, R: int, C: int, sms: int) -> DegreePlan:
    """The two-sided loop's grid for `batch` x R rows against C columns on a
    card with `sms` SMs: 2 rows a thread if the grid of 2-row tiles and
    single segments gives FULL_BLOCKS_PER_SM blocks a SM, else 1; one split
    if the row tiles alone give that many or the split scratch would pass
    SCRATCH_BYTES, else one a segment."""
    segments = _cdiv(C, SEGMENT)
    full = FULL_BLOCKS_PER_SM * sms
    wide = ROWS_PER_THREAD[0]
    rows = wide if _cdiv(R, THREADS * wide) * batch * max(1, segments) >= full else 1
    tiles = _cdiv(R, THREADS * rows)
    unsplit = tiles * batch >= full or 4 * batch * segments * R > SCRATCH_BYTES
    splits = 1 if unsplit else max(1, segments)
    return DegreePlan(batch=batch, rows=rows, tiles=tiles, splits=splits, segments=segments)


def check_plan(plan: DegreePlan, batch: int, R: int, C: int) -> None:
    """Raise unless `plan` is a grid the kernel can run for `batch` x R rows
    against C columns (its tickets and scratch are sized from it)."""
    ok = (plan.rows in ROWS_PER_THREAD and plan.batch == batch
          and plan.tiles == _cdiv(R, THREADS * plan.rows)
          and plan.segments == _cdiv(C, SEGMENT) and 1 <= plan.splits <= max(1, plan.segments))
    if not ok:
        raise ValueError(f"{plan} is no grid of {batch} x {R} rows against {C} columns")


def split_scratch(plan: DegreePlan, R: int, dev: torch.device, stream: int):
    """(part, tickets) of a launch of `plan`: the [batch, segments, R] segment
    sums and the zeroed (batch, row tile) tickets of a split plan, else
    (None, None)."""
    if plan.splits == 1:
        return None, None
    part = torch.empty((plan.batch, plan.segments, R), dtype=torch.float32, device=dev)
    return part, tickets(dev, stream, plan.batch * plan.tiles)


# The symmetric route is taken above this many rows (the reference's TR_MXU).
TRI_MIN_ROWS = 2048
_TRI_TILE = 128  # tile edge of csrc/compat_degrees_tri.cu

# A masked launch of the symmetric kernel keeps the tile pairs it skipped per
# batch element ([batch] int64 on the card, never waited on; read back by
# `scripts/exp_tri_skip.py`): the last TILE_PAIRS_SKIPPED_KEPT masked
# launches, most recent last. An unmasked launch skips nothing and keeps
# nothing.
TILE_PAIRS_SKIPPED_KEPT = 64
TILE_PAIRS_SKIPPED: Deque[torch.Tensor] = deque(maxlen=TILE_PAIRS_SKIPPED_KEPT)


def _is_symmetric(P_rows, Q_rows, P_cols, Q_cols, row_offset, mask_rows, mask_cols) -> bool:
    """Rows and columns are the same points and masks: each condition is
    tested on its own (a tensor or NumPy row offset never takes this route)."""
    same_points = P_rows is P_cols and Q_rows is Q_cols
    same_masks = mask_rows is mask_cols
    zero_offset = type(row_offset) is int and row_offset == 0
    return same_points and same_masks and zero_offset and P_rows.shape[-2] > TRI_MIN_ROWS


def degrees(
    P_rows: torch.Tensor,
    Q_rows: torch.Tensor,
    P_cols: torch.Tensor,
    Q_cols: torch.Tensor,
    params: SacCotParams,
    row_offset: int = 0,
    mask_rows: Optional[torch.Tensor] = None,
    mask_cols: Optional[torch.Tensor] = None,
    mxu: Optional[bool] = None,
) -> torch.Tensor:
    """deg [batch, R] of rows [batch, R, 3] against columns [batch, C, 3].

    Same contract as `engine.compat.degrees`; `row_offset` is the global index
    of row 0 for the explicit i != j test. `mxu` as in `degrees_pallas`:
    None or True route by shape (symmetric or two-sided kernel); False always
    takes the direct two-sided kernel, never the symmetric one.
    """
    if not P_rows.is_cuda:
        return degrees_reference(P_rows, Q_rows, P_cols, Q_cols, params,
                                 row_offset=row_offset, mask_rows=mask_rows,
                                 mask_cols=mask_cols)
    if mxu is False:
        return _two_sided(P_rows, Q_rows, P_cols, Q_cols, params, row_offset, mask_rows,
                          mask_cols, "compat_degrees_direct")
    if _is_symmetric(P_rows, Q_rows, P_cols, Q_cols, row_offset, mask_rows, mask_cols):
        return degrees_tri(P_rows, Q_rows, params, mask=mask_rows)
    return degrees_two_sided(P_rows, Q_rows, P_cols, Q_cols, params, row_offset=row_offset,
                             mask_rows=mask_rows, mask_cols=mask_cols)


def degrees_two_sided(
    P_rows: torch.Tensor,
    Q_rows: torch.Tensor,
    P_cols: torch.Tensor,
    Q_cols: torch.Tensor,
    params: SacCotParams,
    row_offset: int = 0,
    mask_rows: Optional[torch.Tensor] = None,
    mask_cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`degrees` through `csrc/compat_degrees.cu` (CUDA tensors only)."""
    return _two_sided(P_rows, Q_rows, P_cols, Q_cols, params, row_offset, mask_rows,
                      mask_cols, "compat_degrees")


def _two_sided(P_rows, Q_rows, P_cols, Q_cols, params, row_offset, mask_rows, mask_cols,
               counter: str, plan: Optional[DegreePlan] = None) -> torch.Tensor:
    """Launch `csrc/compat_degrees.cu` on the grid of `plan` (by default
    `degree_plan`'s; another one gives the same bits), counted under
    `counter`."""
    batch, R, _ = P_rows.shape
    C = P_cols.shape[1]
    P_rows, Q_rows = f32_points(P_rows, batch, R), f32_points(Q_rows, batch, R)
    P_cols, Q_cols = f32_points(P_cols, batch, C), f32_points(Q_cols, batch, C)
    mask_rows = optional_mask(mask_rows, batch, R, P_rows.device)
    mask_cols = optional_mask(mask_cols, batch, C, P_rows.device)
    dev = P_rows.device
    deg = torch.empty((batch, R), dtype=torch.float32, device=dev)
    if batch == 0 or R == 0:
        return deg
    if plan is None:
        plan = degree_plan(batch, R, C, sm_count(dev))
    check_plan(plan, batch, R, C)
    stream = stream_of(deg)
    part, ticket_buf = split_scratch(plan, R, dev, stream)
    lib = _build.library()
    rc = lib.saccot_compat_degrees(
        ptr(P_rows), ptr(Q_rows), ptr(P_cols), ptr(Q_cols), ptr(mask_rows),
        ptr(mask_cols), ptr(deg), batch, R, C, int(row_offset),
        float(params.compat_tau), float(np.float32(1.0 / params.compat_tau)),
        float(params.min_separation), plan.rows, plan.splits, ptr(part), ptr(ticket_buf),
        stream,
    )
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    debug.check_kernel(counter, deg)
    return deg


def degrees_tri(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """deg [batch, N] of the symmetric problem P, Q [batch, N, 3] (mask
    [batch, N] on both sides), each unordered pair evaluated once by
    `csrc/compat_degrees_tri.cu`; the plain version on CPU tensors.

    Deterministic: pair weights are summed in a fixed order (no atomics), so
    two calls on the same input return the same bits. A masked launch skips
    the tile pairs with no valid row or column and keeps their count in
    `TILE_PAIRS_SKIPPED`.
    """
    if not P.is_cuda:
        return degrees_reference(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    batch, N, _ = P.shape
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    mask = optional_mask(mask, batch, N, P.device)
    deg = torch.empty((batch, N), dtype=torch.float32, device=P.device)
    if batch == 0 or N == 0:
        return deg
    n_tiles = -(-N // _TRI_TILE)
    if n_tiles * (n_tiles + 1) // 2 >= 2 ** 31:
        raise ValueError(f"degrees_tri takes N <= {_TRI_TILE * 65535} (got {N})")
    # Per-tile partial degrees, summed in tile order by the kernel's second pass.
    part = torch.empty((batch, n_tiles, N), dtype=torch.float32, device=P.device)
    skipped = None if mask is None else torch.zeros(batch, dtype=torch.int64, device=P.device)
    lib = _build.library()
    rc = lib.saccot_compat_degrees_tri(
        ptr(P), ptr(Q), ptr(mask), ptr(part), ptr(deg), ptr(skipped), batch, N, n_tiles,
        float(params.compat_tau), float(np.float32(1.0 / params.compat_tau)),
        float(params.min_separation), stream_of(deg),
    )
    _build.check(rc, "compat_degrees_tri")
    _build.LAUNCHES["compat_degrees_tri"] += 1
    debug.check_kernel("compat_degrees_tri", deg)
    if skipped is not None:
        TILE_PAIRS_SKIPPED.append(skipped)
    return deg
