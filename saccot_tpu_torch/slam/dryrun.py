"""Dry-run steps of the sharded SLAM solvers over a process group.

Port of `saccot_tpu/slam/dryrun.py`. Where the JAX package runs one jitted
step under `shard_map` over a mesh's "corr" axis, these run on every rank
of a `torch.distributed` group (`group=None`: one rank):

- `dryrun_ba_step`: a tiny synthetic BA problem (4 poses, 32 landmarks a
  rank, 4 observations each), the landmark axis sharded over the group,
  two Schur-complement Gauss-Newton steps with the real all-reduces;
- `dryrun_pgo_step`: an 8-pose graph (noisy odometry and one loop
  closure), the edge axis sharded over the group (padded with weight-0
  edges), three PCG steps with one all-reduce a CG step.

Each checks that its cost did not rise and returns its result.
`dryrun_rank` runs both on one spawned rank (`dist/local.run_ranks`), on
the group of all ranks and, on the same problem, on that rank alone, so a
caller can hold the sharded results to the one-rank ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from saccot_tpu_torch.dist.collectives import group_rank, group_size
from saccot_tpu_torch.slam.ba import BAProblem, BAResult, bundle_adjust
from saccot_tpu_torch.slam.posegraph import (
    PGOResult, PoseGraph, odometry_chain_init, optimize_pose_graph,
)
from saccot_tpu_torch.utils import se3np


def _tiny_problem(n_poses=4, n_landmarks=64, obs=2, seed=0):
    """The JAX package's dry-run BA problem (the same NumPy draws), as arrays."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(n_poses - 1):
        gt.append(gt[-1] @ se3np.random_transform(rng, max_angle_rad=0.3, max_trans=0.3))
    gt = np.stack(gt).astype(np.float32)
    lm = rng.uniform(-1, 1, size=(n_landmarks, 3)).astype(np.float32)
    obs_pose = rng.integers(0, n_poses, size=(n_landmarks, obs)).astype(np.int32)
    Tinv = np.linalg.inv(gt)[obs_pose]
    z = (np.einsum("lgij,lj->lgi", Tinv[..., :3, :3], lm) + Tinv[..., :3, 3]).astype(np.float32)
    z += rng.normal(scale=0.01, size=z.shape).astype(np.float32)
    pert = np.stack([se3np.exp_se3(rng.normal(scale=0.03, size=6)) for _ in range(n_poses)])
    init = (gt @ pert).astype(np.float32)
    init[0] = np.eye(4, dtype=np.float32)
    return BAProblem(
        poses=init,
        landmarks=lm + rng.normal(scale=0.02, size=lm.shape).astype(np.float32),
        obs_pose=obs_pose.astype(np.int64),
        obs_z=z,
        obs_w=np.ones((n_landmarks, obs), np.float32),
    )


def _rows(x: np.ndarray, group) -> np.ndarray:
    """This rank's contiguous 1/d of the leading axis."""
    d, r = group_size(group), group_rank(group)
    n = x.shape[0] // d
    return x[r * n:(r + 1) * n]


def dryrun_ba_step(group=None, device="cuda", shards=None) -> BAResult:
    """Two landmark-sharded BA steps over `group` (the landmarks of the
    tiny problem, 32 a shard, split into contiguous shards by rank).
    `shards` sizes the problem (by default the group's size)."""
    d = group_size(group)
    # obs=4: multi-view tracks, the G > 2 coupling the track BA builds.
    prob = _tiny_problem(n_landmarks=32 * max(shards or d, 1), obs=4)
    local = BAProblem(
        poses=torch.as_tensor(prob.poses, device=device),
        **{k: torch.as_tensor(_rows(getattr(prob, k), group), device=device)
           for k in ("landmarks", "obs_pose", "obs_z", "obs_w")})
    res = bundle_adjust(local, iters=2, group=group)
    ic, fc = float(res.initial_cost), float(res.final_cost)
    assert fc <= ic, f"BA dryrun cost went up: {ic} -> {fc}"
    print(f"dryrun BA ok over {d} rank(s): cost {ic:.4f} -> {fc:.4f}", flush=True)
    return res


def _pgo_edges(d: int):
    """The JAX package's dry-run pose graph: 8 poses, noisy odometry, one
    loop closure, padded with weight-0 identity edges to a multiple of d."""
    rng = np.random.default_rng(3)
    M = 8
    gt = [np.eye(4)]
    for _ in range(M - 1):
        gt.append(gt[-1] @ se3np.random_transform(rng, max_angle_rad=0.3, max_trans=0.3))
    gt = np.stack(gt)
    ei, ej, meas = [], [], []
    for i in range(M - 1):
        Z = np.linalg.inv(gt[i]) @ gt[i + 1]
        pert = se3np.exp_se3(rng.normal(scale=0.02, size=6))
        ei.append(i)
        ej.append(i + 1)
        meas.append(Z @ pert)
    ei.append(0)
    ej.append(M - 1)
    meas.append(np.linalg.inv(gt[0]) @ gt[M - 1])
    E = len(ei)
    Ep = -(-E // max(d, 1)) * max(d, 1)
    pad = Ep - E
    return (M, np.asarray(ei + [0] * pad, np.int64), np.asarray(ej + [0] * pad, np.int64),
            np.concatenate([np.stack(meas)] + [np.eye(4)[None]] * pad).astype(np.float32),
            np.asarray([1.0] * E + [0.0] * pad, np.float32))


def dryrun_pgo_step(group=None, device="cuda", shards=None) -> PGOResult:
    """Three edge-sharded PCG steps over `group`: edges split into
    contiguous shards by rank, poses replicated. `shards` sets the padding
    (by default the group's size)."""
    d = group_size(group)
    M, ei, ej, meas, w = _pgo_edges(shards or d)
    poses0 = odometry_chain_init(torch.as_tensor(meas[: M - 1], device=device))
    g = PoseGraph(poses=poses0,
                  **{k: torch.as_tensor(_rows(v, group), device=device)
                     for k, v in (("edge_i", ei), ("edge_j", ej), ("meas", meas),
                                  ("weight", w))})
    res = optimize_pose_graph(g, iters=3, solver="pcg", group=group)
    ic, fc = float(res.initial_cost), float(res.final_cost)
    assert fc <= ic + 1e-9, f"PGO dryrun cost went up: {ic} -> {fc}"
    print(f"dryrun distributed PGO ok over {d} rank(s): cost {ic:.4f} -> {fc:.4f}", flush=True)
    return res


def dryrun_rank(device_type: str = "cuda") -> dict:
    """Both dry runs on this rank (spawned by `dist/local.run_ranks`, which
    has joined the process group): over all ranks, then on this rank alone.
    `device_type` "cuda" takes the rank's current card."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device(device_type))
    world = dist.group.WORLD
    return dict(
        rank=dist.get_rank(), backend=dist.get_backend(), world=dist.get_world_size(),
        ba=dryrun_ba_step(world, dev), pgo=dryrun_pgo_step(world, dev),
        ba_one=dryrun_ba_step(None, dev, shards=dist.get_world_size()),
        pgo_one=dryrun_pgo_step(None, dev, shards=dist.get_world_size()),
    )
