"""Mesh resolution (port of `saccot_tpu/features/resolution.py`).

Every threshold of the pipeline is a multiple of the cloud's mesh
resolution `pr`, the mean distance to the nearest other point.
"""

from __future__ import annotations

from typing import Optional

import torch

from saccot_tpu_torch.features.neighbors import knn, neighbor_validity


def mesh_resolution(points: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean distance to the nearest (non-self) neighbour. [N, 3] -> 0-d tensor."""
    d, _ = knn(points, points, k=1, query_mask=mask, ref_mask=mask, exclude_self=True)
    ok = neighbor_validity(d)[:, 0]
    if mask is not None:
        ok = ok & mask.to(torch.bool)
    w = ok.to(points.dtype)
    return (d[:, 0] * w).sum() / torch.clamp_min(w.sum(), 1.0)
