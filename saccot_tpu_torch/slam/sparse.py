"""Segment sums in an order fixed by the shapes, and the conjugate-gradient
solve of the pose graph and of bundle adjustment.

The JAX package reduces per-edge and per-observation blocks into per-pose
blocks with `jax.ops.segment_sum` and solves with
`jax.scipy.sparse.linalg.cg`. On the card `index_add_` / `scatter_add_` add
in an order that changes from run to run, so the port sums **padded segment
rows** instead: the entries are grouped by segment (a stable sort, so each
segment keeps its entries in entry order) into a `[segments, width]` index
table, padded with a zero entry, and each row of the gathered table is
summed over its width. The table depends on the ids alone, so a solve builds
it once and every sum of the solve reuses it; the result has the same bits
on every run.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class Segments(NamedTuple):
    """Layout of a segment sum: `index [segments, width]` holds, row by
    row, the positions of a segment's entries in entry order, padded with
    `n` (a zero entry appended to the values)."""
    index: torch.Tensor
    n: int


def segments(ids: torch.Tensor, num_segments: int,
             keep: Optional[torch.Tensor] = None) -> Segments:
    """The layout of sums of entries with segment `ids` (any shape, flattened
    in row-major order) into `num_segments` segments. Entries where `keep` is
    False are left out: a caller passes it where those entries are exact
    zeros (weight-0 padding), so the sums change by rounding only. One host
    sync (the widest segment)."""
    ids = ids.reshape(-1).to(torch.int64)
    n = ids.numel()
    pos = torch.arange(n, device=ids.device)
    if keep is not None:
        pos = pos[keep.reshape(-1)]
    sid = ids[pos]
    sid, order = torch.sort(sid, stable=True)
    pos = pos[order]
    counts = torch.bincount(sid, minlength=num_segments)
    width = max(int(counts.max()), 1) if sid.numel() else 1
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(sid.numel(), device=ids.device) - starts[sid]
    index = torch.full((num_segments, width), n, dtype=torch.int64, device=ids.device)
    index[sid, slot] = pos
    return Segments(index, n)


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """values [n, ...] -> [segments, ...]: each segment's entries summed over
    the padded row, in entry order."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[seg.index].sum(dim=1)


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum()


# `cg` looks at the stopping rule on the host once every CHECK_EVERY steps.
CHECK_EVERY = 8


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor, tol: float,
       maxiter: int, precond: Callable[[torch.Tensor], torch.Tensor],
       check_every: int = CHECK_EVERY) -> torch.Tensor:
    """Preconditioned conjugate gradients from x0 = 0, with the stopping rule
    of `jax.scipy.sparse.linalg.cg` (atol 0): iterate while
    |r|^2 > tol^2 |b|^2 and fewer than `maxiter` steps have run.

    The loop runs without a host sync: a step past the stopping point leaves
    (x, r, gamma, p) as they were, so x is the iterate where the rule
    stopped. Every `check_every` steps one sync ends the loop once it has
    stopped (the iterate is the same either way). Under a process group
    `matvec` returns the group's sum, so every rank takes the same steps.
    """
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    gamma = _vdot(r, z)
    atol2 = (tol * tol) * _vdot(b, b)
    for k in range(maxiter):
        active = _vdot(r, r) > atol2
        if k and k % check_every == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        gamma_new = _vdot(r_new, z_new)
        p_new = z_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        gamma = torch.where(active, gamma_new, gamma)
        p = torch.where(active, p_new, p)
    return x
