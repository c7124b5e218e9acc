"""Hypothesis scoring and inlier masks — plain PyTorch path.

Port of `saccot_tpu/engine/score.py`. Scoring modes (params.scoring):
  "count":    number of n with |R p_n + t - q_n|^2 < tau^2
  "weighted": sum_n max(0, 1 - |R p_n + t - q_n| * (1/tau))
`inlier_mask` keeps the JAX function's `|.| < tau` test. Residuals are
formed elementwise as ((t - q) + r0 p0) + r1 p1 + r2 p2, the order of the
scoring kernel (`csrc/score.cu`), never through a matmul. With a `group`
the points are one shard of the correspondence axis, and the per-hypothesis
counts and weights are summed over the group (the JAX package's `psum`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from saccot_tpu_torch.dist.collectives import all_reduce


def _residual(R: torch.Tensor, t: torch.Tensor, P: torch.Tensor,
              Q: torch.Tensor) -> torch.Tensor:
    """x[..., n, c] = (t_c - q_nc) + R[c,0] p_n0 + R[c,1] p_n1 + R[c,2] p_n2.

    R [..., 3, 3], t [..., 3] broadcast against P, Q [..., n, 3].
    """
    cols = []
    for c in range(3):
        x = t[..., None, c] - Q[..., c]
        for j in range(3):
            x = x + R[..., None, c, j] * P[..., j]
        cols.append(x)
    return torch.stack(cols, dim=-1)


def score_hypotheses(
    R: torch.Tensor,
    t: torch.Tensor,
    P: torch.Tensor,
    Q: torch.Tensor,
    tau: float,
    mask: Optional[torch.Tensor] = None,
    mode: str = "count",
    block_k: int = 256,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score K hypotheses per batch element against its N correspondences.

    R [batch, K, 3, 3], t [batch, K, 3]; P, Q [batch, N, 3]; mask [batch, N].
    Blocked over K (memory, not semantics). Returns (scores [batch, K] f32,
    counts [batch, K] int32); in "count" mode scores == counts.
    """
    batch, K = R.shape[:2]
    live = None if mask is None else (mask > 0)[:, None, :]
    counts, weights = [], []
    for k0 in range(0, K, block_k):
        x = _residual(R[:, k0:k0 + block_k], t[:, k0:k0 + block_k],
                      P[:, None], Q[:, None])                      # [batch, bk, N, 3]
        d2 = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]
        inl = d2 < tau * tau
        if live is not None:
            inl = inl & live
        counts.append(inl.sum(dim=-1, dtype=torch.int32))
        if mode == "weighted":
            wgt = torch.clamp_min(1.0 - torch.sqrt(d2) * (1.0 / tau), 0.0)
            if live is not None:
                wgt = torch.where(live, wgt, 0.0)
            weights.append(wgt.sum(dim=-1))
    counts = torch.cat(counts, dim=1) if counts else P.new_zeros((batch, 0), dtype=torch.int32)
    if mode == "weighted":
        weights = torch.cat(weights, dim=1) if weights else P.new_zeros((batch, 0))
    else:
        weights = None
    return reduce_scores(counts, weights, group)


def reduce_scores(counts: torch.Tensor, weights: Optional[torch.Tensor],
                  group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, counts) from one shard's counts (and weights, in "weighted"
    mode), summed over `group`. Integer counts sum exactly in any order."""
    counts = all_reduce(counts, group)
    scores = counts.to(torch.float32) if weights is None else all_reduce(weights, group)
    return scores, counts


def inlier_mask(
    R: torch.Tensor,
    t: torch.Tensor,
    P: torch.Tensor,
    Q: torch.Tensor,
    tau: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inliers of one hypothesis per batch element: R [batch, 3, 3], t
    [batch, 3], P, Q [batch, N, 3] -> [batch, N] bool (|residual| < tau)."""
    x = _residual(R, t, P, Q)
    d = torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])
    inl = d < tau
    if mask is not None:
        inl = inl & mask.bool()
    return inl
