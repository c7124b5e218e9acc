"""Surface normals: batched neighbourhood PCA.

Port of `saccot_tpu/features/normals.py`: each point's normal is the
least-significant eigenvector (`features/eig3.py`) of its k-neighbourhood
covariance, oriented toward a viewpoint (the origin by default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from saccot_tpu_torch.features.eig3 import smallest_eigvec3_sym
from saccot_tpu_torch.features.neighbors import knn, neighbor_validity
from saccot_tpu_torch.utils.precision import mm


def weighted_scatter(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] a[..., k, i] b[..., k, j] -> [..., 3, 3].

    Summed over k one neighbour after another, each step one multiply-add
    of (w a_i) b_j rounded once to float32 (the product is exact in
    float64): the JAX package's order on the CPU, so both see the same
    bits. The smallest eigenvalue, ISS's saliency, amplifies a covariance's
    last bits, and its order picks the keypoints.
    """
    prod = (w[..., None] * a)[..., :, None].double() * b[..., None, :].double()
    acc = prod[..., 0, :, :].float()
    for j in range(1, prod.shape[-3]):
        acc = (prod[..., j, :, :] + acc.double()).float()
    return acc


def neighborhood_covariance(
    points: torch.Tensor,
    idx: torch.Tensor,
    valid: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted covariance of gathered neighbourhoods.

    points [N, 3]; idx [M, k]; valid [M, k] -> (cov [M, 3, 3], centroid [M, 3]).
    """
    nb = points[idx]                                   # [M, k, 3]
    w = valid.to(points.dtype)
    if weights is not None:
        w = w * weights
    wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    mu = mm(w[..., None, :], nb)[..., 0, :] / wsum
    c = nb - mu[:, None, :]
    return weighted_scatter(w, c, c) / wsum[..., None], mu


def estimate_normals(
    points: torch.Tensor,
    k: int = 16,
    mask: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
    neighbors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-point unit normals [N, 3] from k-NN PCA, viewpoint-oriented.

    `neighbors`: an optional precomputed self-kNN (dists [N, >= k], idx);
    its ascending columns slice exactly to any smaller k.
    """
    if neighbors is None:
        d, idx = knn(points, points, k=k, query_mask=mask, ref_mask=mask)
    else:
        d, idx = neighbors[0][:, :k], neighbors[1][:, :k]
    cov, _ = neighborhood_covariance(points, idx, neighbor_validity(d))
    n = smallest_eigvec3_sym(cov)
    vp = torch.zeros(3, dtype=points.dtype, device=points.device) if viewpoint is None else viewpoint
    to_vp = vp[None, :] - points
    n = n * torch.where((n * to_vp).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-12)
