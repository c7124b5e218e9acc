"""Rigidity-compatibility graph — plain PyTorch path.

Port of `saccot_tpu/engine/compat.py`. The estimator consumes two reductions
of the (virtual) N x N compatibility matrix: per-node weighted degrees and
the anchor rows. Both are computed blockwise from the points, so nothing is
`[batch, N, N]` at once; `compat_matrix` builds the dense matrix for tests.

One predicate serves every caller (and the CUDA kernels, `csrc/common.cuh`):

    s = (|dp-dq| < tau  and  min(dp, dq) > min_sep  and  i != j) ? 1 - |dp-dq| * (1/tau) : 0

Distances are direct FP32 coordinate differences, ((dx*dx + dy*dy) + dz*dz)
then sqrt, in the order the kernels evaluate them. Every function takes an
explicit leading batch axis: points are `[batch, n, 3]`.
"""

from __future__ import annotations

from typing import Optional

import torch

from saccot_tpu_torch.utils.params import SacCotParams

# Elements of one [batch, rows, cols] block in `degrees` (~128 MB per f32 temp).
_BLOCK_ELEMS = 2 ** 25


def cross_sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., R, 3] x [..., C, 3] -> squared distances ((dx*dx + dy*dy) + dz*dz)."""
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    dz = a[..., :, None, 2] - b[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def cross_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., R, 3] x [..., C, 3] -> Euclidean distances [..., R, C]."""
    return torch.sqrt(cross_sq_distances(a, b))


def pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """Dense distance matrix [..., N, N] of points [..., N, 3], by direct
    differences (the JAX function's Gram trick is a TPU layout)."""
    return cross_distances(x, x)


def pair_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of point pairs [..., 3] -> [...] (same order)."""
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def pair_score(dp: torch.Tensor, dq: torch.Tensor, compat_tau: float,
               min_separation: float) -> torch.Tensor:
    """The compatibility predicate on distance pairs (without the i != j test)."""
    delta = torch.abs(dp - dq)
    ok = (delta < compat_tau) & (torch.minimum(dp, dq) > min_separation)
    return torch.where(ok, 1.0 - delta * (1.0 / compat_tau), 0.0)


def score_block(
    P_rows: torch.Tensor,
    Q_rows: torch.Tensor,
    P_cols: torch.Tensor,
    Q_cols: torch.Tensor,
    params: SacCotParams,
    row_ids: Optional[torch.Tensor] = None,
    col_ids: Optional[torch.Tensor] = None,
    mask_rows: Optional[torch.Tensor] = None,
    mask_cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Compatibility scores between a row block and a column block.

    P_rows/Q_rows: [batch, R, 3]; P_cols/Q_cols: [batch, C, 3] -> [batch, R, C].
    row_ids / col_ids ([R] or [batch, R], [C] or [batch, C]) are the global
    correspondence indices of the blocks, used to zero self-pairs; they
    default to 0..R-1 and 0..C-1. Masks are [batch, R] / [batch, C].
    """
    dev = P_rows.device
    S = pair_score(cross_distances(P_rows, P_cols), cross_distances(Q_rows, Q_cols),
                   params.compat_tau, params.min_separation)
    if row_ids is None:
        row_ids = torch.arange(P_rows.shape[-2], device=dev)
    if col_ids is None:
        col_ids = torch.arange(P_cols.shape[-2], device=dev)
    S = torch.where(row_ids[..., :, None] == col_ids[..., None, :], 0.0, S)
    if mask_rows is not None:
        S = S * mask_rows.to(S.dtype)[..., :, None]
    if mask_cols is not None:
        S = S * mask_cols.to(S.dtype)[..., None, :]
    return S


def degrees(
    P_rows: torch.Tensor,
    Q_rows: torch.Tensor,
    P_cols: torch.Tensor,
    Q_cols: torch.Tensor,
    params: SacCotParams,
    row_offset: int = 0,
    mask_rows: Optional[torch.Tensor] = None,
    mask_cols: Optional[torch.Tensor] = None,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Weighted degree of each row node, deg[b, i] = sum_j S[b, i, j].

    Row blocks of the virtual score matrix are formed and reduced one at a
    time, so peak memory is O(batch * block_rows * C). `row_offset` is the
    global index of row 0 (a caller holding a slice of the rows).
    """
    batch, R, _ = P_rows.shape
    C = P_cols.shape[-2]
    if block_rows is None:
        block_rows = max(1, min(R, _BLOCK_ELEMS // max(1, batch * C)))
    col_ids = torch.arange(C, device=P_rows.device)
    out = []
    for r0 in range(0, R, block_rows):
        r1 = min(R, r0 + block_rows)
        row_ids = torch.arange(row_offset + r0, row_offset + r1, device=P_rows.device)
        S = score_block(
            P_rows[:, r0:r1], Q_rows[:, r0:r1], P_cols, Q_cols, params,
            row_ids=row_ids, col_ids=col_ids,
            mask_rows=None if mask_rows is None else mask_rows[:, r0:r1],
            mask_cols=mask_cols,
        )
        out.append(S.sum(dim=-1))
    return torch.cat(out, dim=1) if out else P_rows.new_zeros((batch, 0))


def compat_matrix(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense compatibility matrix S [batch, N, N] (tests and small N)."""
    return score_block(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
