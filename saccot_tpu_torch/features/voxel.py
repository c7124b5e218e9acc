"""Voxel-grid downsampling with static output shapes.

Port of `saccot_tpu/features/voxel.py`. Points are sorted by integer voxel
coordinate, lexicographically (x, then y, then z) as `lax.sort(num_keys=3)`
does: three stable argsorts, z first. Invalid points take the 2^31 - 1
sentinel and sort last. Run boundaries become compact segment ids; voxels
past the `max_points` budget are dropped in sort order.

The per-voxel sums run in a fixed order, with no atomics: a segmented
inclusive scan over the sorted points (log2 N doubling steps, each adding
the partial sum s places back where it lies in the same run), read at the
last point of each run. A repeat call on the card gives the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SENTINEL = 2**31 - 1


def _segment_totals(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive sums of `vals` [N, C] within runs of equal `seg` [N]
    (sorted), by doubling steps."""
    n = vals.shape[0]
    s = 1
    while s < n:
        same = (seg[s:] == seg[:-s])[:, None]
        vals = torch.cat([vals[:s], vals[s:] + torch.where(same, vals[:-s], 0.0)])
        s *= 2
    return vals


def voxel_downsample(
    points: torch.Tensor,
    voxel_size,
    max_points: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 3] -> (centroids [max_points, 3], valid [max_points] bool).
    `voxel_size` may be a float or a 0-d tensor."""
    N = points.shape[0]
    dev = points.device
    m = torch.ones(N, dtype=torch.bool, device=dev) if mask is None else mask.to(torch.bool)
    coords = torch.floor(points / voxel_size).to(torch.int32)
    coords = torch.where(m[:, None], coords, SENTINEL)
    order = torch.arange(N, device=dev)
    for axis in (2, 1, 0):
        order = order[torch.sort(coords[order, axis], stable=True).indices]
    c = coords[order]
    new_run = torch.ones(N, dtype=torch.bool, device=dev)
    new_run[1:] = (c[1:] != c[:-1]).any(dim=1)
    seg = torch.cumsum(new_run.to(torch.int32), 0) - 1
    valid_pt = m[order]
    seg = torch.clamp_max(torch.where(valid_pt, seg, max_points), max_points)

    ones = valid_pt.to(points.dtype)
    vals = torch.cat([points[order] * ones[:, None], ones[:, None]], dim=1)   # [N, 4]
    totals = _segment_totals(vals, seg)
    last = torch.ones(N, dtype=torch.bool, device=dev)
    last[:-1] = seg[1:] != seg[:-1]
    # The last point of each run writes its run's totals into the run's slot
    # (every slot is written at most once; the overflow slot is dropped).
    out = torch.zeros(max_points + 1, 4, dtype=points.dtype, device=dev)
    out[torch.where(last, seg, max_points).long()] = torch.where(last[:, None], totals, 0.0)
    sums, cnts = out[:max_points, :3], out[:max_points, 3]
    valid = cnts > 0
    centroids = sums / torch.clamp_min(cnts, 1.0)[:, None]
    return torch.where(valid[:, None], centroids, 0.0), valid
