"""FPFH descriptors as batched histogram tensor ops.

Port of `saccot_tpu/features/fpfh.py`: SPFH of every point (Darboux-frame
angles alpha, phi, theta against each of its k neighbours, 11 bins per
angle, hard or soft), then FPFH_i = SPFH_i + the 1/distance-weighted mean
of the neighbours' SPFH, L2-normalised, at the keypoints.

The bin sums are dense rows (one-hot or soft split weights per neighbour)
summed over the neighbour axis, an order fixed by the shapes, not the
JAX package's `segment_sum`: a repeat call on the card gives the same bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from saccot_tpu_torch.features.neighbors import knn, neighbor_validity
from saccot_tpu_torch.utils.precision import mm

FPFH_DIM = 33
_BINS = 11


def _angle_bins(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(((x - lo) / (hi - lo) * _BINS).to(torch.int64), 0, _BINS - 1)


def _angle_bins_soft(x: torch.Tensor, lo: float, hi: float):
    """Linear-interpolated (clamped) bin split: ((lo_i, w_lo), (hi_i, w_hi))."""
    c = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0) * _BINS - 0.5
    f0 = torch.floor(c)
    f = c - f0
    i0 = f0.to(torch.int64)
    return (i0.clamp(0, _BINS - 1), 1.0 - f), ((i0 + 1).clamp(0, _BINS - 1), f)


def spfh(
    points: torch.Tensor,
    normals: torch.Tensor,
    idx: torch.Tensor,
    valid: torch.Tensor,
    dist: torch.Tensor,
    soft: bool = False,
) -> torch.Tensor:
    """Simplified point feature histograms [N, 33]."""
    q, nq = points[idx], normals[idx]                        # [N, k, 3]
    diff = q - points[:, None, :]
    u = normals[:, None, :].expand_as(diff)
    pq = diff / torch.clamp_min(dist, 1e-12)[..., None]
    v = torch.linalg.cross(pq, u, dim=-1)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)
    w = torch.linalg.cross(u, v, dim=-1)

    alpha = (v * nq).sum(-1)
    phi = (u * pq).sum(-1)
    theta = torch.atan2((w * nq).sum(-1), (u * nq).sum(-1))

    wgt = valid.to(torch.float32)
    blocks = []
    for x, lo, hi in ((alpha, -1.0, 1.0), (phi, -1.0, 1.0), (theta, -math.pi, math.pi)):
        if soft:
            (i0, w0), (i1, w1) = _angle_bins_soft(x, lo, hi)
            rows = (F.one_hot(i0, _BINS) * (wgt * w0)[..., None]
                    + F.one_hot(i1, _BINS) * (wgt * w1)[..., None])
        else:
            rows = F.one_hot(_angle_bins(x, lo, hi), _BINS) * wgt[..., None]
        blocks.append(rows.sum(1))
    hist = torch.cat(blocks, dim=-1)
    return hist / torch.clamp_min(wgt.sum(-1, keepdim=True), 1.0)


def fpfh_descriptors(
    points: torch.Tensor,
    normals: torch.Tensor,
    kp_idx: torch.Tensor,
    radius,
    k: int = 32,
    mask: Optional[torch.Tensor] = None,
    approx: bool = False,
    soft: bool = False,
) -> torch.Tensor:
    """FPFH descriptors [M, 33] at the keypoint indices `kp_idx`; `radius`
    may be a float or a 0-d tensor. approx: accepted for the JAX package's
    callers; the neighbour search is exact either way (`neighbors.knn`)."""
    d, idx = knn(points, points, k=k, query_mask=mask, ref_mask=mask, exclude_self=True)
    valid = neighbor_validity(d, radius=radius)
    s = spfh(points, normals, idx, valid, d, soft=soft)

    wgt = torch.where(valid, valid.to(torch.float32) / torch.clamp_min(d, 1e-9), 0.0)
    pooled = mm(wgt[:, None, :], s[idx])[:, 0]
    f = (s + pooled / torch.clamp_min(wgt.sum(-1, keepdim=True), 1e-9))[kp_idx]
    return f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), 1e-9)
