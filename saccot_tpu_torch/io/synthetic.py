"""Synthetic problems (the port's own copy of `blob_cloud`,
`correspondence_problem` and `two_view_pair` from
`saccot_tpu/io/synthetic.py`).

A smooth closed surface (a spherical-harmonic-deformed sphere), a planted
rigid transform, correspondence sets with a controlled outlier fraction,
and two partially overlapping noisy views of one surface for the
cloud-to-transform pipeline. Deterministic given the seed: the same seed
gives the JAX package's arrays bit for bit (`tests/test_torch_isolation.py`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from saccot_tpu_torch.utils import se3np


def blob_cloud(rng: np.random.Generator, n_points: int = 4096, order: int = 4,
               deform: float = 0.25) -> np.ndarray:
    """Sample points on a randomly deformed unit sphere (smooth closed surface).

    Radial field r(dir) = 1 + deform * sum_m a_m * cos(f_m . dir + phase_m)
    with low-frequency f.
    """
    dirs = rng.normal(size=(n_points, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = np.ones(n_points)
    for _ in range(order):
        f = rng.normal(scale=2.0, size=3)
        a = rng.uniform(0.3, 1.0) / order
        phase = rng.uniform(0, 2 * np.pi)
        r += deform * a * np.cos(dirs @ f + phase)
    return dirs * r[:, None]


def correspondence_problem(
    seed: int = 0,
    n: int = 1000,
    outlier_ratio: float = 0.5,
    noise: float = 0.005,
    n_points: int = 4096,
    max_angle: float = np.pi / 2,
    max_trans: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Planted registration problem at the correspondence level.

    N putative correspondences of which a fraction are true matches under
    the (hidden) rigid T_gt and the rest are random mismatches. Returns P, Q
    [n, 3] float32, T_gt [4, 4], gt_inliers [n] bool.
    """
    rng = np.random.default_rng(seed)
    cloud = blob_cloud(rng, n_points)
    T_gt = se3np.random_transform(rng, max_angle_rad=max_angle, max_trans=max_trans)

    sel = rng.choice(n_points, size=n, replace=False)
    P = cloud[sel]
    Q = se3np.apply_T(T_gt, P) + rng.normal(scale=noise, size=(n, 3))

    n_out = int(round(n * outlier_ratio))
    out_idx = rng.choice(n, size=n_out, replace=False)
    gt_inliers = np.ones(n, dtype=bool)
    gt_inliers[out_idx] = False
    # Mismatches: pair P[i] with the transform of some other random surface
    # point, a wrong but plausible target location.
    wrong = cloud[rng.choice(n_points, size=n_out)]
    Q[out_idx] = se3np.apply_T(T_gt, wrong) + rng.normal(scale=noise, size=(n_out, 3))

    return dict(
        P=P.astype(np.float32),
        Q=Q.astype(np.float32),
        T_gt=T_gt,
        gt_inliers=gt_inliers,
    )


def two_view_pair(
    seed: int = 0,
    n_points: int = 8192,
    overlap: float = 0.7,
    noise: float = 0.003,
    max_angle: float = np.pi / 3,
    max_trans: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Two partially overlapping views of one blob surface.

    The source view keeps the points above one quantile of their direction
    along a random axis, the target view those below another, sharing an
    `overlap` fraction in the middle; each is cut at `n_points`. The target
    is transformed by T_gt (target = T_gt * source frame), and each view
    gets independent sensor noise.
    """
    rng = np.random.default_rng(seed)
    cloud = blob_cloud(rng, n_points * 2)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    d = (cloud / np.linalg.norm(cloud, axis=1, keepdims=True)) @ axis
    src = cloud[d > np.quantile(d, 0.5 - overlap / 2)][:n_points]
    tgt_world = cloud[d < np.quantile(d, 0.5 + overlap / 2)][:n_points]

    T_gt = se3np.random_transform(rng, max_angle_rad=max_angle, max_trans=max_trans)
    src_noisy = src + rng.normal(scale=noise, size=src.shape)
    tgt = se3np.apply_T(T_gt, tgt_world) + rng.normal(scale=noise, size=tgt_world.shape)
    return dict(
        source=src_noisy.astype(np.float32),
        target=tgt.astype(np.float32),
        T_gt=T_gt,
    )
