"""Descriptor matching as a Gram product and a top-k.

Port of `saccot_tpu/match/topk.py`: brute-force squared distances in
descriptor space (one FP32 matrix product, `features/neighbors.gram`),
each source's two nearest targets, the mutual check, and `mutual_filter`,
which front-packs the best `max_matches` by distance. Every selection
breaks ties to the lowest index, as `lax.top_k` and `argmin` do: the
nearest targets by int64 (distance bits, index) keys, the back match by
`torch.min` (the first minimum), the filter by a stable sort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from saccot_tpu_torch.features.neighbors import gram, smallest_k, sqrt_rn
from saccot_tpu_torch.kernels.triangles import topk_stable


class Matches(NamedTuple):
    src_idx: torch.Tensor   # [M] int64 indices into source keypoints
    tgt_idx: torch.Tensor   # [M] int64 indices into target keypoints
    distance: torch.Tensor  # [M] float32 descriptor distances
    valid: torch.Tensor     # [M] bool


def _sq_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Ns, D] x [Nt, D] -> squared L2 distances [Ns, Nt] via the Gram trick."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    return torch.clamp_min(a2[:, None] + b2[None, :] - 2.0 * gram(a, b), 0.0)


def match_descriptors(
    desc_src: torch.Tensor,
    desc_tgt: torch.Tensor,
    mask_src: Optional[torch.Tensor] = None,
    mask_tgt: Optional[torch.Tensor] = None,
    mutual: bool = True,
    ratio_test: float = 0.0,
) -> Matches:
    """Nearest-neighbour correspondences in descriptor space: one candidate
    per source row ([Ns] fixed shape), `valid` marking the survivors of the
    mask, the optional Lowe ratio test (d1/d2 < ratio_test) and the
    optional mutual check."""
    BIG = 1e30
    Ns = desc_src.shape[0]
    d2 = _sq_distance_matrix(desc_src, desc_tgt)
    if mask_tgt is not None:
        d2 = torch.where(mask_tgt.to(torch.bool)[None, :], d2, BIG)

    # A single target gives d2nd == d1, so the ratio test rejects all.
    k2 = min(2, d2.shape[1])
    top2, idx_top2 = smallest_k(d2, k2)
    nn_idx, d1, d2nd = idx_top2[:, 0], top2[:, 0], top2[:, k2 - 1]

    valid = d1 < BIG
    if mask_src is not None:
        valid = valid & mask_src.to(torch.bool)
    if ratio_test > 0.0:
        valid = valid & (sqrt_rn(d1) < ratio_test * sqrt_rn(torch.clamp_min(d2nd, 1e-30)))
    rows = torch.arange(Ns, device=desc_src.device)
    if mutual:
        d2_t = d2.transpose(0, 1)
        if mask_src is not None:
            d2_t = torch.where(mask_src.to(torch.bool)[None, :], d2_t, BIG)
        back = torch.min(d2_t, dim=-1).indices          # the first minimum
        valid = valid & (back[nn_idx] == rows)
    return Matches(src_idx=rows, tgt_idx=nn_idx, distance=sqrt_rn(d1), valid=valid)


def mutual_filter(matches: Matches, max_matches: int) -> Matches:
    """The best `max_matches` valid matches by descriptor distance,
    front-packed; invalid slots get distance +inf and valid=False."""
    score = torch.where(matches.valid, -matches.distance, -torch.inf) + 0.0   # no -0.0
    _, order = topk_stable(score, min(max_matches, score.shape[0]))
    valid = matches.valid[order]
    return Matches(
        src_idx=matches.src_idx[order],
        tgt_idx=matches.tgt_idx[order],
        distance=torch.where(valid, matches.distance[order], torch.inf),
        valid=valid,
    )


def gather_correspondences(kp_src: torch.Tensor, kp_tgt: torch.Tensor, matches: Matches):
    """(P, Q, mask) point arrays for the estimator."""
    return kp_src[matches.src_idx], kp_tgt[matches.tgt_idx], matches.valid.to(torch.float32)
