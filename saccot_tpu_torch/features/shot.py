"""SHOT descriptors as batched histogram tensor ops.

Port of `saccot_tpu/features/shot.py`: per keypoint, a weighted-covariance
local reference frame (LRF) with sign disambiguation, then 32 spatial
volumes (8 azimuth x 2 elevation x 2 radial) x 11 cosine bins = 352-D,
hard or soft (quadrilinear) binning, L2-normalised.

The JAX package sums the bins with one `segment_sum`. Here each neighbour's
weights form a dense [352] row (the outer product of its per-axis bin
weights, in the JAX product order), and the rows are summed over the
neighbour axis: an order fixed by the shapes, with no atomics, so a repeat
call on the card gives the same bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from saccot_tpu_torch.features.eig3 import extreme_eigvecs3_sym
from saccot_tpu_torch.features.neighbors import knn, neighbor_validity
from saccot_tpu_torch.features.normals import weighted_scatter
from saccot_tpu_torch.utils.precision import mm

SHOT_DIM = 352  # 8 * 2 * 2 spatial volumes x 11 cosine bins


def local_reference_frames(
    points: torch.Tensor,
    kp_idx: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_valid: torch.Tensor,
    nbr_dist: torch.Tensor,
    radius,
) -> torch.Tensor:
    """Disambiguated LRFs [M, 3, 3]; rows are the x, y, z axes.

    Weights (radius - d); the largest eigenvector is x, the smallest z,
    each flipped toward the majority of the neighbours; y = z cross x.
    """
    rel = points[nbr_idx] - points[kp_idx][:, None, :]           # [M, k, 3]
    w = torch.clamp_min(radius - nbr_dist, 0.0) * nbr_valid.to(points.dtype)
    wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    z, x = extreme_eigvecs3_sym(weighted_scatter(w, rel, rel) / wsum[..., None])

    def disambiguate(axis):
        proj = mm(rel, axis[:, :, None])[..., 0]
        vote = torch.where(nbr_valid, torch.sign(proj), 0.0).sum(-1)
        return axis * torch.where(vote < 0, -1.0, 1.0)[:, None]

    x, z = disambiguate(x), disambiguate(z)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], dim=-2)


def _soft_axis(c: torch.Tensor, nbins: int, wrap: bool):
    """Linear split of the continuous bin coordinate c in [0, nbins):
    ((lo_idx, w_lo), (hi_idx, w_hi)); bin centres at i + 0.5; `wrap` wraps
    the neighbour bin (azimuth), else it clamps (mass merges into the edge
    bin)."""
    cc = c - 0.5
    lo = torch.floor(cc)
    f = cc - lo
    lo_i = lo.to(torch.int64)
    hi_i = lo_i + 1
    if wrap:
        lo_i, hi_i = torch.remainder(lo_i, nbins), torch.remainder(hi_i, nbins)
    else:
        lo_i, hi_i = lo_i.clamp(0, nbins - 1), hi_i.clamp(0, nbins - 1)
    return (lo_i, 1.0 - f), (hi_i, f)


def split_weights(split, nbins: int) -> torch.Tensor:
    """[..., nbins] dense weights of a `_soft_axis` split (both parts added
    where a clamp puts them in one bin)."""
    (lo, w_lo), (hi, w_hi) = split
    return (F.one_hot(lo, nbins) * w_lo[..., None]) + (F.one_hot(hi, nbins) * w_hi[..., None])


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., m] x [..., n] -> [..., m * n], a's index major."""
    return (a[..., :, None] * b[..., None, :]).flatten(-2)


def shot_descriptors(
    points: torch.Tensor,
    normals: torch.Tensor,
    kp_idx: torch.Tensor,
    radius,
    k: int = 64,
    mask: Optional[torch.Tensor] = None,
    approx: bool = False,
    soft: bool = False,
) -> torch.Tensor:
    """SHOT descriptors [M, 352] of the keypoints `kp_idx` of a cloud.

    Invalid keypoints produce whatever their slot-0 gather gives; callers
    carry the keypoint mask. soft=True: quadrilinear interpolation
    (azimuth wrapped, elevation/radial/cosine clamped), each neighbour
    spread over 2^4 bins. `radius` may be a float or a 0-d tensor. approx:
    accepted for the JAX package's callers; the neighbour search is exact
    either way (`neighbors.knn`).
    """
    kp = points[kp_idx]
    d, idx = knn(kp, points, k=k, ref_mask=mask)
    valid = neighbor_validity(d, radius=radius) & (d > 1e-9)   # not the keypoint itself

    lrf = local_reference_frames(points, kp_idx, idx, valid, d, radius)
    nb = points[idx] - kp[:, None, :]
    local = mm(nb, lrf.transpose(-1, -2))                       # [M, k, 3] in LRF (x, y, z)
    lx, ly, lz = local.unbind(-1)
    az_c = (torch.atan2(ly, lx) + math.pi) / (2 * math.pi) * 8
    cos_t = mm(normals[idx], lrf[:, 2, :, None])[..., 0]
    cos_c = torch.clamp((cos_t + 1.0) * 0.5, 0.0, 1.0) * 11
    w0 = valid.to(torch.float32)

    if not soft:
        az = torch.clamp(az_c.to(torch.int64), 0, 7)
        el = (lz >= 0).to(torch.int64)
        rad = (d >= radius * 0.5).to(torch.int64)
        cos = torch.clamp(cos_c.to(torch.int64), 0, 10)
        bins = ((az * 2 + el) * 2 + rad) * 11 + cos
        rows = F.one_hot(bins, SHOT_DIM) * w0[..., None]
    else:
        dn = torch.clamp_min(d, 1e-9)
        el_c = torch.clamp((lz / dn + 1.0) * 0.5, 0.0, 1.0) * 2
        rad_c = torch.clamp(d / radius, 0.0, 1.0) * 2
        rows = w0[..., None] * split_weights(_soft_axis(az_c, 8, wrap=True), 8)
        rows = _outer(rows, split_weights(_soft_axis(el_c, 2, wrap=False), 2))
        rows = _outer(rows, split_weights(_soft_axis(rad_c, 2, wrap=False), 2))
        rows = _outer(rows, split_weights(
            _soft_axis(torch.clamp_max(cos_c, 11.0 - 1e-4), 11, wrap=False), 11))
    hist = rows.sum(1)
    return hist / torch.clamp_min(torch.linalg.vector_norm(hist, dim=-1, keepdim=True), 1e-9)
