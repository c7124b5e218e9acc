"""One ring step of the sharded degrees: CUDA kernel wrapper and its plain
PyTorch version.

Replaces `saccot_tpu/kernels/ring_compat.py::_ring_degree_kernel` with
`csrc/ring_degrees.cu`. The TPU fuses the whole ring into one program with
in-kernel remote copies; the port launches one compute kernel per ring step
and moves the column blocks between steps with `torch.distributed`
(`dist/ring.degrees_ring` holds the schedule). The step is an instance of the
two-sided degree loop (`csrc/degree_loops.cuh`) on the grid of
`kernels/compat.degree_plan`, so a step at d = 1 on a zeroed `deg` gives
`compat.degrees(..., mxu=False)` bit for bit.

Blocks use the TPU's packed, coordinate-major layout `[batch, 8, n_pad]`
float32: rows 0-2 source xyz, 3-5 target xyz, 6 the validity mask, 7 pad,
with the point axis padded to a multiple of `PAD` by mask-0 columns. One ring
hop is then one contiguous message.
"""

from __future__ import annotations

import numpy as np
import torch

from saccot_tpu_torch.engine import compat as compat_mod
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import f32_tensor, ptr, sm_count, stream_of
from saccot_tpu_torch.kernels.compat import degree_plan, split_scratch
from saccot_tpu_torch.utils import debug
from saccot_tpu_torch.utils.params import SacCotParams

PACKED_ROWS = 8
PAD = 128  # the point axis is padded to a multiple of this, as the TPU pads lanes


def pack_block(P: torch.Tensor, Q: torch.Tensor, mask=None) -> torch.Tensor:
    """P, Q [batch, n, 3] (mask [batch, n]) -> packed [batch, 8, n_pad] f32."""
    batch, n, _ = P.shape
    n_pad = -(-n // PAD) * PAD
    blk = torch.zeros((batch, PACKED_ROWS, n_pad), dtype=torch.float32, device=P.device)
    blk[:, 0:3, :n] = P.to(torch.float32).transpose(1, 2)
    blk[:, 3:6, :n] = Q.to(torch.float32).transpose(1, 2)
    blk[:, 6, :n] = 1.0 if mask is None else mask.to(torch.float32)
    return blk


def unpack_block(blk: torch.Tensor, n: int):
    """Packed [batch, 8, n_pad] -> (P, Q [batch, n, 3], mask [batch, n]) views."""
    return (blk[:, 0:3, :n].transpose(1, 2), blk[:, 3:6, :n].transpose(1, 2), blk[:, 6, :n])


def ring_degrees_step_reference(
    blk_rows: torch.Tensor,
    blk_cols: torch.Tensor,
    deg: torch.Tensor,
    row_base: int,
    col_base: int,
    params: SacCotParams,
) -> torch.Tensor:
    """Plain version of `ring_degrees_step`: `engine.compat.score_block` over
    row blocks (so no [batch, n_loc, n_loc] tensor is formed at once), the
    row sums added to `deg` in place."""
    batch, n_loc = deg.shape
    P_r, Q_r, m_r = unpack_block(blk_rows, n_loc)
    P_c, Q_c, m_c = unpack_block(blk_cols, n_loc)
    col_ids = col_base + torch.arange(n_loc, device=deg.device)
    rows = max(1, min(n_loc, compat_mod._BLOCK_ELEMS // max(1, batch * n_loc)))
    for r0 in range(0, n_loc, rows):
        r1 = min(n_loc, r0 + rows)
        S = compat_mod.score_block(
            P_r[:, r0:r1], Q_r[:, r0:r1], P_c, Q_c, params,
            row_ids=row_base + torch.arange(r0, r1, device=deg.device), col_ids=col_ids,
            mask_rows=m_r[:, r0:r1], mask_cols=m_c,
        )
        deg[:, r0:r1] += S.sum(dim=-1)
    return deg


def ring_degrees_step(
    blk_rows: torch.Tensor,
    blk_cols: torch.Tensor,
    deg: torch.Tensor,
    row_base: int,
    col_base: int,
    params: SacCotParams,
) -> torch.Tensor:
    """Add, in place, the degree contribution of the local rows (packed
    `blk_rows`, global ids `row_base + i`) against one column block (packed
    `blk_cols`, global ids `col_base + j`) to `deg` [batch, n_loc], for every
    pair of the batch; returns `deg`. Both blocks hold n_loc points.

    CUDA tensors launch `csrc/ring_degrees.cu`; CPU tensors take the plain
    version.
    """
    if not deg.is_cuda:
        return ring_degrees_step_reference(blk_rows, blk_cols, deg, row_base, col_base, params)
    batch, n_loc = deg.shape
    n_pad = blk_rows.shape[-1]
    if n_pad < n_loc:
        raise ValueError(f"packed blocks hold {n_pad} columns, deg has {n_loc} rows")
    blk_rows = f32_tensor(blk_rows, (batch, PACKED_ROWS, n_pad), "blk_rows")
    blk_cols = f32_tensor(blk_cols, (batch, PACKED_ROWS, n_pad), "blk_cols")
    if not deg.is_contiguous() or deg.dtype != torch.float32:
        raise ValueError("deg must be a contiguous float32 tensor (it is updated in place)")
    if batch == 0 or n_loc == 0:
        return deg
    plan = degree_plan(batch, n_loc, n_loc, sm_count(deg.device))
    stream = stream_of(deg)
    part, ticket_buf = split_scratch(plan, n_loc, deg.device, stream)
    lib = _build.library()
    rc = lib.saccot_ring_degrees(
        ptr(blk_rows), ptr(blk_cols), ptr(deg), batch, n_loc, n_pad, int(row_base),
        int(col_base), float(params.compat_tau), float(np.float32(1.0 / params.compat_tau)),
        float(params.min_separation), plan.rows, plan.splits, ptr(part), ptr(ticket_buf), stream,
    )
    _build.check(rc, "ring_degrees")
    _build.LAUNCHES["ring_degrees"] += 1
    debug.check_kernel("ring_degrees", deg)
    return deg
