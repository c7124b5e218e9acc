"""ISS (Intrinsic Shape Signatures) keypoints, fixed budget.

Port of `saccot_tpu/features/iss.py`. Per point: eigenvalues l1 >= l2 >= l3
of the neighbourhood scatter; salient iff l2/l1 < gamma21 and
l3/l2 < gamma32; saliency l3; non-maximum suppression over the NMS
neighbourhood; the best `max_keypoints` by saliency, with a validity mask.

The selection is a stable sort (saliency desc, index asc), `lax.top_k`'s
order: most scores are the -1.0 of a rejected point, and their tie order
sets which indices fill the unused slots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from saccot_tpu_torch.features.eig3 import eigvals3_sym
from saccot_tpu_torch.features.neighbors import knn, neighbor_validity
from saccot_tpu_torch.features.normals import neighborhood_covariance
from saccot_tpu_torch.kernels.triangles import topk_stable


class Keypoints(NamedTuple):
    idx: torch.Tensor       # [max_keypoints] int64 indices into the cloud
    xyz: torch.Tensor       # [max_keypoints, 3]
    saliency: torch.Tensor  # [max_keypoints] float32
    valid: torch.Tensor     # [max_keypoints] bool


def select_keypoints(points: torch.Tensor, score: torch.Tensor, max_keypoints: int) -> Keypoints:
    """The `max_keypoints` best of `score` [N] (-1.0 where rejected), ties
    to the lowest index, padded with index 0 and score -1.0."""
    top_s, top_i = topk_stable(score, min(max_keypoints, score.shape[0]))
    pad = max_keypoints - top_s.shape[0]
    if pad > 0:
        top_i = torch.cat([top_i, top_i.new_zeros(pad)])
        top_s = torch.cat([top_s, top_s.new_full((pad,), -1.0)])
    return Keypoints(idx=top_i, xyz=points[top_i], saliency=top_s.to(torch.float32),
                     valid=top_s > 0)


def iss_keypoints(
    points: torch.Tensor,
    salient_radius,
    nms_radius,
    max_keypoints: int,
    gamma21: float = 0.975,
    gamma32: float = 0.975,
    k: int = 32,
    min_neighbors: int = 5,
    mask: Optional[torch.Tensor] = None,
    neighbors: Optional[tuple] = None,
) -> Keypoints:
    """Up to `max_keypoints` ISS keypoints.

    `k` caps the neighbourhood; radii may be floats or 0-d tensors.
    `neighbors`: an optional precomputed self-kNN (dists [N, >= k], idx,
    self included) shared with the normals; NMS masks its self slot and
    takes one column more where the set has it.
    """
    N = points.shape[0]
    k_nms = min(k + 1, N)
    if neighbors is None:
        d_nms, idx_nms = knn(points, points, k=k_nms, query_mask=mask, ref_mask=mask)
    else:
        k_nms = min(k_nms, neighbors[0].shape[1])
        d_nms, idx_nms = neighbors[0][:, :k_nms], neighbors[1][:, :k_nms]
    d, idx = d_nms[:, :k], idx_nms[:, :k]
    valid = neighbor_validity(d, radius=salient_radius)

    cov, _ = neighborhood_covariance(points, idx, valid)
    evals = eigvals3_sym(cov)                       # ascending: l3, l2, l1
    l3, l2, l1 = evals[..., 0], evals[..., 1], evals[..., 2]

    eps = 1e-12
    salient = ((l2 / torch.clamp_min(l1, eps) < gamma21)
               & (l3 / torch.clamp_min(l2, eps) < gamma32)
               & (l3 > eps)
               & (valid.sum(-1) >= min_neighbors))
    if mask is not None:
        salient = salient & mask.to(torch.bool)

    # NMS: keep i iff l3_i >= l3_j for every non-self neighbour j within
    # nms_radius.
    rows = torch.arange(N, device=points.device)[:, None]
    in_nms = neighbor_validity(d_nms, radius=nms_radius) & (idx_nms != rows)
    nbr_sal = torch.where(in_nms, l3[idx_nms], -torch.inf)
    keep = salient & (l3 >= nbr_sal.amax(-1))
    return select_keypoints(points, torch.where(keep, l3, -1.0), max_keypoints)
