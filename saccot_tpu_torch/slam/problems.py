"""Synthetic pose-graph and bundle-adjustment problems (NumPy draws).

The generators of the JAX package's SLAM tests (`tests/test_slam.py`:
`_make_pg_problem`, `_make_ba_problem`, `ate_rmse`), restated for the port:
the same draws from the same seed, as port tensors on `device`.
`chip_smoke.py` runs the tests' two scale points on them (PGO with PCG at
M=256, BA at M=128, L=4096).
"""

from __future__ import annotations

import numpy as np
import torch

from saccot_tpu_torch.slam.ba import BAProblem
from saccot_tpu_torch.slam.posegraph import PoseGraph, odometry_chain_init
from saccot_tpu_torch.utils import se3np


def _rand_pose(rng, angle=0.8, trans=1.0):
    return se3np.random_transform(rng, max_angle_rad=angle, max_trans=trans).astype(np.float32)


def pose_graph_problem(seed=0, M=12, loop=True, noise=0.03, loop_noise=0.002, device="cuda"):
    """(PoseGraph, gt [M, 4, 4]): a noisy odometry chain of M poses and, with
    `loop`, three precise loop closures; initial poses chain the odometry."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(M - 1):
        gt.append((gt[-1] @ _rand_pose(rng, angle=0.4, trans=0.5)).astype(np.float32))
    gt = np.stack(gt)
    edges_i, edges_j, meas = [], [], []

    def add_edge(i, j, sigma):
        Z = np.linalg.inv(gt[i]) @ gt[j]
        pert = se3np.exp_se3(rng.normal(scale=sigma, size=6))
        edges_i.append(i)
        edges_j.append(j)
        meas.append((Z @ pert).astype(np.float32))

    for i in range(M - 1):
        add_edge(i, i + 1, noise)
    if loop:
        add_edge(M - 1, 0, loop_noise)
        add_edge(0, M // 2, loop_noise)
        add_edge(M // 4, 3 * M // 4, loop_noise)
    meas = torch.as_tensor(np.stack(meas), device=device)
    graph = PoseGraph(
        poses=odometry_chain_init(meas[: M - 1]),
        edge_i=torch.as_tensor(edges_i, dtype=torch.int64, device=device),
        edge_j=torch.as_tensor(edges_j, dtype=torch.int64, device=device),
        meas=meas,
        weight=torch.ones((len(edges_i),), dtype=torch.float32, device=device),
    )
    return graph, gt


def ba_problem(seed=0, M=6, L=64, G=4, noise=0.01, init_noise=0.05, device="cuda"):
    """(BAProblem, gt poses [M, 4, 4], gt landmarks [L, 3]): L landmarks
    seen G times each from random poses (some last slots padding), noisy
    observations, perturbed initial poses (pose 0 pinned) and landmarks."""
    rng = np.random.default_rng(seed)
    gt_poses = [np.eye(4, dtype=np.float32)]
    for _ in range(M - 1):
        gt_poses.append((gt_poses[-1] @ _rand_pose(rng, angle=0.3, trans=0.4)).astype(np.float32))
    gt_poses = np.stack(gt_poses)
    gt_lm = rng.uniform(-2, 2, size=(L, 3)).astype(np.float32)
    obs_pose = rng.integers(0, M, size=(L, G)).astype(np.int32)
    Tinv = np.linalg.inv(gt_poses)[obs_pose]
    z = np.einsum("lgij,lj->lgi", Tinv[..., :3, :3], gt_lm) + Tinv[..., :3, 3]
    z = (z + rng.normal(scale=noise, size=z.shape)).astype(np.float32)
    w = np.ones((L, G), np.float32)
    w[:, -1] = (rng.uniform(size=L) > 0.3)
    pert = np.stack([se3np.exp_se3(rng.normal(scale=init_noise, size=6)) for _ in range(M)])
    init_poses = (gt_poses @ pert).astype(np.float32)
    init_poses[0] = np.eye(4, dtype=np.float32)
    init_lm = (gt_lm + rng.normal(scale=init_noise, size=gt_lm.shape)).astype(np.float32)
    prob = BAProblem(*(torch.as_tensor(x, device=device) for x in (
        init_poses, init_lm, obs_pose.astype(np.int64), z, w)))
    return prob, gt_poses, gt_lm


def ate_rmse(poses: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of positions after aligning the first pose (the gauge)."""
    rel = np.linalg.inv(poses[0]) @ poses
    rel_gt = np.linalg.inv(gt[0]) @ gt
    d = rel[:, :3, 3] - rel_gt[:, :3, 3]
    return float(np.sqrt((d ** 2).sum(-1).mean()))
