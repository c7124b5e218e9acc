"""k-nearest-neighbour search as blocked Gram products and a top-k.

Port of `saccot_tpu/features/neighbors.py`. A brute-force distance matrix,
1024 query rows a step, so the peak is O(block * N); the k smallest
distances of each row by `(distance, index)` order, the lowest index first
among ties, as `lax.top_k` gives them. `approx=True` is accepted and
takes the exact selection: the JAX function's `lax.approx_max_k` has no
torch counterpart (and is exact on the CPU), so recall can only match or
exceed it.

The squared distances are `|q|^2 + |r|^2 - 2 q.r` in the order the JAX
function computes them on the CPU: the Gram product as a fused
multiply-add chain over the 3 coordinates (`gram3`), the squared norms as
`sq_norms` says. They give the JAX package's bits (run op by op, as its
tests run it), so both sides select the same neighbours, and the same
bits on the card. On the card the products run in true FP32
whatever the process-wide TF32 setting says.

All outputs are fixed-shape [M, k]; missing neighbours have distance BIG
(1e30) and index 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from saccot_tpu_torch.utils.precision import mm

BIG = 1e30


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, D] x [..., N, D] -> [..., M, N] inner products, in full FP32."""
    return mm(a, b.transpose(-1, -2))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (through float64, where a * b is
    exact)."""
    return (a.double() * b.double() + c.double()).float()


def gram3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, 3] x [..., N, 3] -> [..., M, N] inner products as the
    multiply-add chain a0 b0 -> + a1 b1 -> + a2 b2 that a float32 matrix
    product takes on the CPU (the JAX package's bits), whatever the shape
    or device; no TF32 can touch it."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root, correctly rounded on every device (through
    float64; torch's vectorised CPU root can be an ulp off)."""
    return torch.sqrt(x.double()).float()


def sq_norms(x: torch.Tensor, fused: bool) -> torch.Tensor:
    """[..., 3] -> [...] squared norms, summed as a multiply-add chain over
    the coordinates (`fused`) or as rounded products added left to right:
    the JAX package's `sum(x * x, -1)` on the CPU takes the chain inside a
    compiled loop body (the query block) and the plain sum outside it (the
    reference points)."""
    if fused:
        return fma(x[..., 2], x[..., 2], fma(x[..., 1], x[..., 1], x[..., 0] * x[..., 0]))
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest of each row of a non-negative
    [M, N] float32, ascending, ties to the lowest index: a top-k of int64
    keys (distance bits, column), which are all distinct."""
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)   # + 0.0: no -0.0
    cols = torch.arange(d2.shape[-1], device=d2.device, dtype=torch.int64)
    keys = torch.topk((bits << 32) | cols, k, dim=-1, largest=False, sorted=True).values
    idx = keys & 0xFFFFFFFF
    return torch.gather(d2, -1, idx), idx


def knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    k: int,
    query_mask: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    exclude_self: bool = False,
    block_rows: int = 1024,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs of each query point.

    query: [M, 3]; ref: [N, 3]; masks: optional validity of padded rows;
    exclude_self: drop the i == j pair (self-kNN); approx: accepted for the
    JAX package's callers, the search is exact either way.

    Returns (dists [M, k], idx [M, k] int64): Euclidean distances ascending;
    padded or missing neighbours have dist BIG and idx 0.
    """
    M, N = query.shape[0], ref.shape[0]
    k = min(k, N)
    dev = query.device
    r2 = sq_norms(ref, fused=False)
    rm = None if ref_mask is None else ref_mask.to(torch.bool)
    qm = None if query_mask is None else query_mask.to(torch.bool)
    cols = torch.arange(N, device=dev)
    ds, ids = [], []
    for start in range(0, M, block_rows):
        qb = query[start:start + block_rows]
        d2 = torch.clamp_min(sq_norms(qb, fused=True)[:, None] + r2[None, :] - 2.0 * gram3(qb, ref), 0.0)
        if rm is not None:
            d2 = torch.where(rm[None, :], d2, BIG)
        if exclude_self:
            rows = start + torch.arange(qb.shape[0], device=dev)
            d2 = torch.where(rows[:, None] == cols[None, :], BIG, d2)
        if qm is not None:
            d2 = torch.where(qm[start:start + block_rows, None], d2, BIG)
        if k == 1:
            # min returns the first minimum: the lowest index among ties.
            v, i = torch.min(d2, dim=1, keepdim=True)
        else:
            v, i = smallest_k(d2, k)
        ds.append(sqrt_rn(torch.clamp_min(v, 0.0)))
        ids.append(i)
    d, i = torch.cat(ds), torch.cat(ids)
    invalid = d >= BIG ** 0.5 - 1.0
    return torch.where(invalid, BIG, d), torch.where(invalid, 0, i)


def neighbor_validity(dists: torch.Tensor, radius=None) -> torch.Tensor:
    """Boolean mask of usable neighbour slots ([..., k]); `radius` may be a
    float or a 0-d tensor."""
    ok = dists < BIG ** 0.5 - 1.0
    if radius is not None:
        ok = ok & (dists < radius)
    return ok
