"""Bundle adjustment: Schur-complement Gauss-Newton with matrix-free PCG.

Port of `saccot_tpu/slam/ba.py`. Joint refinement of scan poses T_i and map
landmarks l_k from point-to-point observations. Each landmark block is
eliminated locally (a 3x3 inverse), and the reduced camera system
S = H_pp - W H_ll^{-1} W^T is solved by preconditioned conjugate gradients
(`slam/sparse.cg`, the rule of `jax.scipy.sparse.linalg.cg`) without ever
forming S: each matvec streams through the observation slots. With `group`
the landmark axis is sharded over the ranks of a process group: each rank
holds its landmarks' whole observation groups, and one all-reduce sums
the [M, 6] product of each CG step, and the block-Jacobi preconditioner
and the reduced gradient once a Gauss-Newton step, as the JAX package
`psum`s under `axis_name`.

Observations are grouped by landmark with a fixed budget G per landmark
(padding slots carry weight 0). Residual and Jacobians (right perturbation
T <- T exp(v, w)):
    r = R_i z + t_i - l_k,   dr/dv = R_i,   dr/dw = -R_i [z]_x,   dr/dl = -I

No atomics: the per-pose blocks are summed as **padded segment rows**
(`slam/sparse.py`): the slots are grouped by pose with a stable sort into a
[M, width] table built once a solve, and each pose's row is summed over the
width, so the sums run in an order fixed by the shapes and repeat bit for
bit on the card. Weight-0 padding slots contribute exact zeros and are left
out of the table (the sums change by rounding only). Every block
contraction runs in full FP32 (reduced precision makes the LM guard reject
every step).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from saccot_tpu_torch.dist.collectives import all_reduce
from saccot_tpu_torch.slam import se3
from saccot_tpu_torch.slam.sparse import Segments, cg, segment_sum, segments
from saccot_tpu_torch.utils.precision import einsum as _es
from saccot_tpu_torch.utils.precision import full_fp32


class BAProblem(NamedTuple):
    poses: torch.Tensor      # [M, 4, 4]
    landmarks: torch.Tensor  # [L, 3] (this rank's shard under a group)
    obs_pose: torch.Tensor   # [L, G] int pose index per observation slot
    obs_z: torch.Tensor      # [L, G, 3] observed point in scan frame
    obs_w: torch.Tensor      # [L, G] weights; 0 marks padding


class BAResult(NamedTuple):
    poses: torch.Tensor
    landmarks: torch.Tensor
    initial_cost: torch.Tensor  # global under a group
    final_cost: torch.Tensor
    lam: torch.Tensor = 0.0     # final LM damping (checkpoint for resume)


def _residuals(poses, landmarks, prob: BAProblem):
    """r [L, G, 3] and the rotations gathered per slot [L, G, 3, 3]."""
    T = poses[prob.obs_pose.to(torch.int64)]
    R, t = T[..., :3, :3], T[..., :3, 3]
    world = _es("lgij,lgj->lgi", R, prob.obs_z) + t
    return world - landmarks[:, None, :], R


def ba_cost(poses, landmarks, prob: BAProblem, group=None,
            robust_delta: Optional[float] = None):
    """Total (optionally Huber-robustified) weighted squared residual:
    rho(|r|) = |r|^2 below delta, 2 delta |r| - delta^2 above."""
    r, _ = _residuals(poses, landmarks, prob)
    d2 = torch.sum(r * r, dim=-1)
    if robust_delta is not None:
        d = torch.sqrt(torch.clamp_min(d2, 1e-24))
        rho = torch.where(d <= robust_delta, d2,
                          2.0 * robust_delta * d - robust_delta * robust_delta)
    else:
        rho = d2
    return all_reduce(torch.sum(prob.obs_w * rho), group)


def _gn_system(poses, landmarks, prob: BAProblem, num_poses: int, lm_damping: float,
               robust_delta: Optional[float], slots: Segments):
    """This rank's part of the reduced camera system, in block form: (Hpp
    [M, 6, 6] block-diagonal pose Hessian, b_red [M, 6] reduced gradient,
    Fdiag [M, 6, 6] same-slot Schur fill-in for the block-Jacobi
    preconditioner, Hll_inv [L, 3, 3], bl [L, 3], W [L, G, 6, 3]).
    `slots` lays out the L*G slots over the poses."""
    r, R = _residuals(poses, landmarks, prob)                  # [L,G,3], [L,G,3,3]
    w = prob.obs_w
    if robust_delta is not None:
        # Huber IRLS weight, fixed within the step.
        d = torch.sqrt(torch.clamp_min(torch.sum(r * r, dim=-1), 1e-24))
        w = w * torch.clamp_max(robust_delta / d, 1.0)

    zhat = se3.hat(prob.obs_z)                                 # [L, G, 3, 3]
    A = torch.cat([R, -_es("lgij,lgjk->lgik", R, zhat)], dim=-1)   # [L, G, 3, 6]
    wA = w[..., None, None] * A
    AtA = _es("lgai,lgaj->lgij", A, wA)                        # [L, G, 6, 6]
    Atr = _es("lgai,lga->lgi", A, w[..., None] * r)            # [L, G, 6]
    Hpp = segment_sum(AtA.reshape(-1, 6, 6), slots)
    bp = segment_sum(Atr.reshape(-1, 6), slots)

    # Landmark blocks: H_ll = (sum_g w) I + damping; b_l = -sum_g w r.
    wsum = torch.sum(w, dim=-1)
    eye3 = torch.eye(3, dtype=w.dtype, device=w.device)
    Hll_inv = eye3[None] / (wsum + lm_damping)[:, None, None]  # [L, 3, 3]
    bl = -torch.sum(w[..., None] * r, dim=1)                   # [L, 3]

    W = -wA.transpose(-1, -2)                                  # [L, G, 6, 3]
    WH = _es("lgab,lbc->lgac", W, Hll_inv)                     # [L, G, 6, 3]
    # Same-slot fill-in W_g Hll^-1 W_g^T by pose: the block-Jacobi
    # preconditioner (the matvec itself is exact).
    Dslot = _es("lgac,lgdc->lgad", WH, W)                      # [L, G, 6, 6]
    Fdiag = segment_sum(Dslot.reshape(-1, 6, 6), slots)
    bfill = segment_sum(_es("lgac,lc->lga", WH, bl).reshape(-1, 6), slots)
    return Hpp, bp - bfill, Fdiag, Hll_inv, bl, W


def _schur_matvec(x, Hpp, Hll_inv, W, obs_pose, lam, free, slots: Segments, group=None):
    """y = S x with S = Hpp - W Hll^{-1} W^T + lam I, gauge-projected; the
    fill-in streams through this rank's slots and one all-reduce gives the
    group's product."""
    xm = x * free
    y = _es("mab,mb->ma", Hpp, xm)
    u = _es("lgac,lga->lc", W, xm[obs_pose])                   # W^T x
    v = _es("lab,lb->la", Hll_inv, u)
    c = _es("lgac,lc->lga", W, v)                              # W Hll^-1 W^T x
    y = all_reduce(y - segment_sum(c.reshape(-1, 6), slots), group)
    return (y + lam * xm) * free + (1.0 - free) * x


def bundle_adjust(
    prob: BAProblem,
    iters: int = 5,
    damping: float = 1e-6,
    lm_damping: float = 1e-6,
    group=None,
    cg_iters: int = 64,
    cg_tol: float = 1e-6,
    lam0: Optional[torch.Tensor] = None,
    robust_delta: Optional[float] = None,
) -> BAResult:
    """Fixed-iteration Schur Gauss-Newton with matrix-free PCG; landmark-
    sharded over `group` when it is given.

    The damping is Levenberg-Marquardt-adaptive (a rejected step raises it
    10x, an accepted one lowers it 0.3x, floored at `damping`); pass `lam0`
    (the `lam` of an earlier result) to resume mid-solve with the schedule
    intact.
    """
    M = prob.poses.shape[0]
    dt, dev = prob.poses.dtype, prob.poses.device
    obs_pose = prob.obs_pose.to(torch.int64)
    prob = prob._replace(obs_pose=obs_pose)
    slots = segments(obs_pose, M, keep=prob.obs_w != 0)
    initial_cost = ba_cost(prob.poses, prob.landmarks, prob, group, robust_delta)
    free = (torch.arange(M, device=dev) >= 1).to(dt)[:, None]     # [M, 1]
    eye6 = torch.eye(6, dtype=dt, device=dev)

    poses, landmarks, cost = prob.poses, prob.landmarks, initial_cost
    lam = torch.as_tensor(damping if lam0 is None else lam0, dtype=dt, device=dev).clone()
    for _ in range(iters):
        Hpp, b_red, Fdiag, Hll_inv, bl, W = _gn_system(poses, landmarks, prob, M, lm_damping,
                                                       robust_delta, slots)
        b_red = all_reduce(b_red, group)
        Sdiag = all_reduce(Hpp - Fdiag, group) + lam * eye6[None]
        Sdiag = torch.where(free[:, :, None] > 0, Sdiag, eye6[None])
        with full_fp32():
            Pinv = torch.linalg.inv(Sdiag)                            # [M, 6, 6]

        def matvec(x):
            return _schur_matvec(x, Hpp, Hll_inv, W, obs_pose, lam, free, slots, group)

        def precond(x):
            return _es("mab,mb->ma", Pinv, x * free) + (1.0 - free) * x

        dx = cg(matvec, -b_red * free, cg_tol, cg_iters, precond) * free
        # Back-substitute the landmarks: dl = -Hll^-1 (bl + sum_g W_g^T dx).
        Wtdx = _es("lgac,lga->lc", W, dx[obs_pose])
        dl = -_es("lab,lb->la", Hll_inv, bl + Wtdx)

        new_poses = se3.compose(poses, se3.exp_se3(dx))
        new_landmarks = landmarks + dl
        # The cost is global under a group, so every rank takes the same branch.
        new_cost = ba_cost(new_poses, new_landmarks, prob, group, robust_delta)
        better = new_cost <= cost
        poses = torch.where(better, new_poses, poses)
        landmarks = torch.where(better, new_landmarks, landmarks)
        cost = torch.where(better, new_cost, cost)
        lam = torch.where(better, torch.clamp_min(lam * 0.3, damping), lam * 10.0)
    return BAResult(poses=poses, landmarks=landmarks, initial_cost=initial_cost,
                    final_cost=cost, lam=lam)
