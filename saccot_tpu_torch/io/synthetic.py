"""Synthetic problems (the port's own copy of `blob_cloud`,
`correspondence_problem`, `two_view_pair`, `slam_sequence` and
`model_views` from `saccot_tpu/io/synthetic.py`).

A smooth closed surface (a spherical-harmonic-deformed sphere), a planted
rigid transform, correspondence sets with a controlled outlier fraction,
two partially overlapping noisy views of one surface for the
cloud-to-transform pipeline, a set of views of one model for the
all-pairs (U3M) sweep, and a scan sequence with its per-edge
correspondence sets for sequence SLAM. Deterministic given the seed: the
same seed gives the JAX package's arrays bit for bit
(`tests/test_torch_isolation.py`).
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


def slam_sequence(
    seed: int = 0,
    n_scans: int = 8,
    n_corr: int = 256,
    outlier_ratio: float = 0.4,
    noise: float = 0.004,
    loop_every: int = 0,
    n_world: int = 8192,
    step_angle: float = 0.25,
    step_trans: float = 0.4,
) -> Dict[str, np.ndarray]:
    """Synthetic multi-scan SLAM problem (BASELINE.json configs[4]).

    A world surface is observed from a chain of poses T_i (world <- scan).
    For every edge (consecutive pairs plus optional loop closures) a
    correspondence problem is emitted in the two scans' local frames with a
    planted outlier fraction — exactly what the pairwise SAC-COT front end
    consumes. Ground-truth poses are returned for ATE evaluation.

    Returns dict with:
      poses_gt [M, 4, 4]; edges [E, 2] int; edge_P/edge_Q [E, n_corr, 3]
      (P in frame i, Q in frame j); edge_is_loop [E] bool.
    """
    rng = np.random.default_rng(seed)
    world = blob_cloud(rng, n_world, deform=0.3) * 4.0  # scene-scale blob

    poses = [np.eye(4)]
    for _ in range(n_scans - 1):
        poses.append(poses[-1] @ se3np.random_transform(
            rng, max_angle_rad=step_angle, max_trans=step_trans))
    poses_gt = np.stack(poses)

    edges = [(i, i + 1) for i in range(n_scans - 1)]
    if loop_every and n_scans > loop_every:
        edges += [(i, i + loop_every) for i in range(0, n_scans - loop_every, loop_every)]
        edges.append((0, n_scans - 1))

    edge_P, edge_Q, is_loop = [], [], []
    for (i, j) in edges:
        sel = rng.choice(n_world, size=n_corr, replace=False)
        pts_w = world[sel]
        p_i = se3np.apply_T(np.linalg.inv(poses_gt[i]), pts_w)
        p_j = se3np.apply_T(np.linalg.inv(poses_gt[j]), pts_w)
        p_i = p_i + rng.normal(scale=noise, size=p_i.shape)
        p_j = p_j + rng.normal(scale=noise, size=p_j.shape)
        n_out = int(round(n_corr * outlier_ratio))
        out_idx = rng.choice(n_corr, size=n_out, replace=False)
        wrong_w = world[rng.choice(n_world, size=n_out)]
        p_j[out_idx] = se3np.apply_T(np.linalg.inv(poses_gt[j]), wrong_w)
        edge_P.append(p_i.astype(np.float32))
        edge_Q.append(p_j.astype(np.float32))
        is_loop.append(abs(i - j) > 1)

    return dict(
        poses_gt=poses_gt,
        edges=np.asarray(edges, np.int32),
        edge_P=np.stack(edge_P),
        edge_Q=np.stack(edge_Q),
        edge_is_loop=np.asarray(is_loop),
        world=world.astype(np.float32),
    )


def model_views(
    seed: int = 0,
    n_views: int = 8,
    n_points: int = 4096,
    cap_frac: float = 0.55,
    noise: float = 0.002,
    max_angle: float = 0.8,
    max_trans: float = 0.5,
):
    """V partial views of ONE model surface, for the U3M all-pairs sweep.

    The U3M protocol registers every unordered pair of a model's view set
    (BASELINE.json:8 "full pairwise registration sweep") — views share
    varying amounts of surface, so pairwise overlap spans near-0 to
    ~cap_frac. Views are index subsets of a shared model cloud: view v
    keeps the cap_frac fraction of points most aligned with its (Fibonacci
    -sphere) view direction, then moves into its own random frame + noise.

    Returns dict(views=[V arrays [n_v, 3]], T=[V, 4, 4] world->view,
    idx=[V index arrays], model=[N, 3]) where exact pairwise overlap is
    |idx_i & idx_j| / min(|idx_i|, |idx_j|) — no geometric threshold
    needed at evaluation time.
    """
    rng = np.random.default_rng(seed)
    model = blob_cloud(rng, n_points * 2)
    dirs_n = model / np.linalg.norm(model, axis=1, keepdims=True)

    # Fibonacci sphere view directions.
    i = np.arange(n_views) + 0.5
    phi = np.arccos(1 - 2 * i / n_views)
    theta = np.pi * (1 + 5**0.5) * i
    vdirs = np.stack([np.sin(phi) * np.cos(theta),
                      np.sin(phi) * np.sin(theta),
                      np.cos(phi)], axis=1)

    views, Ts, idxs = [], [], []
    for v in range(n_views):
        score = dirs_n @ vdirs[v]
        keep = np.argsort(-score)[: int(cap_frac * len(model))][:n_points]
        keep = np.sort(keep)
        T = se3np.random_transform(rng, max_angle_rad=max_angle,
                                   max_trans=max_trans)
        pts = se3np.apply_T(T, model[keep])
        pts = pts + rng.normal(scale=noise, size=pts.shape)
        views.append(pts.astype(np.float32))
        Ts.append(T)
        idxs.append(keep)
    return dict(views=views, T=np.stack(Ts), idx=idxs,
                model=model.astype(np.float32))
