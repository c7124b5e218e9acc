"""The one traffic generator: planted correspondence problems, made in torch
on the device from the run's seed.

A copy of the port's synthetic problems (`correspondence_problem` and
`blob_cloud` of `saccot_tpu_torch/io/synthetic.py`, with the kitti scaling
of `utils/convert.kitti_problem_batch`), drawn from the same distributions
but batched and on the device: a smooth closed surface (a deformed unit
sphere) per pair, a planted rigid transform, N putative correspondences of
which a share are mismatches. Every number the generator needs comes from a
configuration file (`configs/<name>.json`, key "problem") and a traffic file
(`traffic/<name>.json`); the same seed gives the same problems.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

_F64 = torch.float64


def _rotation(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: unit axes [batch, 3], angles [batch] -> R [batch, 3, 3]."""
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    W = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(-1, 3, 3)
    s = torch.sin(angle)[:, None, None]
    c = (1.0 - torch.cos(angle))[:, None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * W + c * (W @ W)


def planted_batch(gen: torch.Generator, batch: int, n: int, problem: Dict,
                  n_valid: Optional[Tuple[int, int]] = None, device="cuda"):
    """`batch` planted problems of n correspondences.

    problem: outlier_ratio, noise (in the configuration's units), scale (the
    unit surface's size in those units), points_per_corr (surface points
    sampled per correspondence, or `surface_points` for a fixed count),
    max_angle (radians), max_trans (unit-surface units). n_valid: a range
    [lo, hi]; pair b keeps its first n_b ~ U[lo, hi] correspondences and the
    rest are masked.

    Returns P, Q [batch, n, 3] float32, T_gt [batch, 4, 4] float64 and the
    mask [batch, n] bool (None without n_valid), all on `device`.
    """
    scale = float(problem.get("scale", 1.0))
    n_points = int(problem.get("surface_points") or problem["points_per_corr"] * n)
    noise = float(problem["noise"]) / scale
    kw = dict(generator=gen, device=device, dtype=_F64)

    # The surface: unit directions pushed out by a few low-frequency waves.
    order, deform = 4, 0.25
    dirs = torch.randn(batch, n_points, 3, **kw)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    freq = 2.0 * torch.randn(batch, order, 3, **kw)
    amp = (0.3 + 0.7 * torch.rand(batch, order, **kw)) / order
    phase = 2.0 * math.pi * torch.rand(batch, order, **kw)
    waves = torch.cos(torch.einsum("bnk,bmk->bnm", dirs, freq) + phase[:, None, :])
    cloud = dirs * (1.0 + deform * (amp[:, None, :] * waves).sum(-1))[..., None]
    del dirs, waves

    # The planted transform: a random axis, an angle in [0.1, max_angle].
    axis = torch.randn(batch, 3, **kw)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    angle = 0.1 + (float(problem["max_angle"]) - 0.1) * torch.rand(batch, **kw)
    R = _rotation(axis, angle)
    t = float(problem["max_trans"]) * (2.0 * torch.rand(batch, 3, **kw) - 1.0)

    def moved(pts):
        return pts @ R.transpose(1, 2) + t[:, None, :] + noise * torch.randn(pts.shape, **kw)

    # n distinct surface points, their true images, then the mismatches: a
    # share of the rows get the image of another random surface point.
    sel = torch.rand(batch, n_points, **kw).argsort(dim=1)[:, :n]
    P = torch.gather(cloud, 1, sel[..., None].expand(batch, n, 3))
    Q = moved(P)
    n_out = int(round(n * float(problem["outlier_ratio"])))
    if n_out:
        out_idx = torch.rand(batch, n, **kw).argsort(dim=1)[:, :n_out]
        wrong_idx = torch.randint(0, n_points, (batch, n_out), generator=gen, device=device)
        wrong = torch.gather(cloud, 1, wrong_idx[..., None].expand(batch, n_out, 3))
        Q.scatter_(1, out_idx[..., None].expand(batch, n_out, 3), moved(wrong))

    T_gt = torch.zeros(batch, 4, 4, dtype=_F64, device=device)
    T_gt[:, :3, :3] = R
    T_gt[:, :3, 3] = t * scale
    T_gt[:, 3, 3] = 1.0
    mask = None
    if n_valid is not None:
        lo, hi = int(n_valid[0]), int(n_valid[1])
        keep = torch.randint(lo, hi + 1, (batch, 1), generator=gen, device=device)
        mask = torch.arange(n, device=device)[None, :] < keep
    return (P * scale).to(torch.float32), (Q * scale).to(torch.float32), T_gt, mask


def cell_batches(seed: int, config: Dict, traffic: Dict, device="cuda"):
    """The distinct batches of one run: `traffic["distinct_batches"]` lists of
    (P, Q, T_gt, mask), each of `traffic["pairs_per_call"]` pairs of the
    configuration's N, from one generator seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 63 - 1))
    n_valid = traffic.get("n_valid")
    return [planted_batch(gen, int(traffic["pairs_per_call"]), int(config["n"]),
                          config["problem"], n_valid=n_valid, device=device)
            for _ in range(int(traffic["distinct_batches"]))]
