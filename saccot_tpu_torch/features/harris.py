"""Harris-3D keypoints, fixed budget (port of `saccot_tpu/features/harris.py`).

Per point, the covariance C of the normals over its neighbourhood; the
response is the 2-D Harris measure on its two dominant eigenvalues,
l1 l2 - k (l1 + l2)^2. NMS and the budgeted selection as in ISS
(`features/iss.py`, ties to the lowest index).
"""

from __future__ import annotations

from typing import Optional

import torch

from saccot_tpu_torch.features.eig3 import eigvals3_sym
from saccot_tpu_torch.features.iss import Keypoints, select_keypoints
from saccot_tpu_torch.features.neighbors import knn, neighbor_validity
from saccot_tpu_torch.features.normals import weighted_scatter
from saccot_tpu_torch.utils.precision import mm


def harris_keypoints(
    points: torch.Tensor,
    normals: torch.Tensor,
    radius,
    nms_radius,
    max_keypoints: int,
    k: int = 32,
    harris_k: float = 0.04,
    min_neighbors: int = 5,
    mask: Optional[torch.Tensor] = None,
) -> Keypoints:
    """Up to `max_keypoints` Harris-3D keypoints; radii may be floats or
    0-d tensors."""
    d, idx = knn(points, points, k=k, query_mask=mask, ref_mask=mask)
    valid = neighbor_validity(d, radius=radius)

    nb_normals = normals[idx]                            # [N, k, 3]
    w = valid.to(points.dtype)
    wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    mu = mm(w[..., None, :], nb_normals)[..., 0, :] / wsum
    c = nb_normals - mu[:, None, :]
    C = weighted_scatter(w, c, c) / wsum[..., None]

    evals = eigvals3_sym(C)
    l1, l2 = evals[..., 2], evals[..., 1]
    response = l1 * l2 - harris_k * (l1 + l2) ** 2

    keep = (valid.sum(-1) >= min_neighbors) & (response > 0)
    if mask is not None:
        keep = keep & mask.to(torch.bool)

    d_nms, idx_nms = knn(points, points, k=k, query_mask=mask, ref_mask=mask, exclude_self=True)
    in_nms = neighbor_validity(d_nms, radius=nms_radius)
    keep = keep & (response >= torch.where(in_nms, response[idx_nms], -torch.inf).amax(-1))
    return select_keypoints(points, torch.where(keep, response, -1.0), max_keypoints)
