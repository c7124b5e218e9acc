"""Pose-graph optimization: on-manifold Gauss-Newton over SE(3).

Port of `saccot_tpu/slam/posegraph.py`. Nodes are scan poses T_i (world <-
scan); edges carry relative measurements Z_ij ~= T_i^{-1} T_j with a weight
or a 6x6 information matrix.

Residual (right-perturbation convention):
    r_ij = log( Z_ij^{-1} * T_i^{-1} * T_j )  in R^6,  T <- T * exp(dx)

The per-edge Jacobians are forward-mode derivatives of that residual at
dx = 0, taken through the port's own exp/log maps (`slam/se3.py`), as the
JAX package takes `jax.jacfwd`: one dual pass over the twelve unit
directions of (dx_i, dx_j), batched over the edges. Two solvers run the one
Levenberg-Marquardt loop:
- "dense": the normal system assembled as [6M, 6M] and solved directly
  (`torch.linalg.solve`, as the JAX package calls `jnp.linalg.solve`);
- "pcg": matrix-free conjugate gradients over the edge stream with the
  block-Jacobi preconditioner (`slam/sparse.cg`, the rule of
  `jax.scipy.sparse.linalg.cg`); with `group` the edges are this rank's
  shard and the per-pose sums are all-reduced (the JAX package's `psum`
  under `axis_name`).
Per-pose sums are padded segment rows (`slam/sparse.py`), never atomics.
The Gauss-Newton loop is a Python loop with no host sync in it; the gauge is
fixed by pinning pose 0. Every product and normal equation runs in full
FP32 (`utils/precision`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from saccot_tpu_torch.dist.collectives import all_reduce
from saccot_tpu_torch.slam import se3
from saccot_tpu_torch.slam.sparse import Segments, cg, segment_sum, segments
from saccot_tpu_torch.utils.precision import einsum as _es
from saccot_tpu_torch.utils.precision import full_fp32


class PoseGraph(NamedTuple):
    poses: torch.Tensor    # [M, 4, 4] initial pose estimates (world <- scan)
    edge_i: torch.Tensor   # [E] int source node
    edge_j: torch.Tensor   # [E] int target node
    meas: torch.Tensor     # [E, 4, 4] measured Z_ij ~= T_i^{-1} T_j
    weight: torch.Tensor   # [E] scalar edge weights (info = weight * I6)
    info: Optional[torch.Tensor] = None  # optional [E, 6, 6] full information


def edge_residual(T_i, T_j, Z_ij):
    """r = log(Z^{-1} T_i^{-1} T_j) in R^6 (batched over leading dims)."""
    return se3.log_se3(se3.compose(se3.inv(Z_ij), se3.compose(se3.inv(T_i), T_j)))


def _edge_residual_perturbed(xi_i, xi_j, T_i, T_j, Z_ij):
    Ti = se3.compose(T_i, se3.exp_se3(xi_i))
    Tj = se3.compose(T_j, se3.exp_se3(xi_j))
    return edge_residual(Ti, Tj, Z_ij)


def _edge_jacobians(T_i, T_j, Z_ij):
    """(r [E, 6], J_i [E, 6, 6], J_j [E, 6, 6]) at xi = 0: one forward-mode
    pass over 12 copies of the edges, copy k carrying the unit tangent e_k
    of (xi_i, xi_j)."""
    E = T_i.shape[0]
    dt, dev = T_i.dtype, T_i.device
    tangent = torch.eye(12, dtype=dt, device=dev)[:, None, :].expand(12, E, 12)
    zero = torch.zeros((12, E, 6), dtype=dt, device=dev)
    with fwAD.dual_level():
        xi_i = fwAD.make_dual(zero, tangent[..., :6].contiguous())
        xi_j = fwAD.make_dual(zero.clone(), tangent[..., 6:].contiguous())
        r = _edge_residual_perturbed(xi_i, xi_j, T_i, T_j, Z_ij)
        primal, jvp = fwAD.unpack_dual(r)
    # jvp[k, e, a] = d r_a / d (xi)_k
    J = jvp.permute(1, 2, 0)                                   # [E, 6, 12]
    return primal[0], J[..., :6].contiguous(), J[..., 6:].contiguous()


def _edge_sq_error(r, graph: PoseGraph):
    """Per-edge weighted squared error s_e = r^T L r (or w |r|^2)."""
    if graph.info is not None:
        return _es("ea,eab,eb->e", r, graph.info, r)
    return graph.weight * torch.sum(r * r, dim=-1)


def robust_weight(s, robust: Optional[str], delta: float):
    """IRLS weight omega(s) for weighted squared error s.

    "huber": omega = min(1, delta/sqrt(s)); "dcs": dynamic covariance
    scaling, omega = min(1, 2 delta^2 / (delta^2 + s)); "tls": truncated
    least squares, omega = 1{s <= delta^2}. delta is in units of the
    whitened residual (the square root of the weighted squared error).
    """
    if robust is None or robust == "none":
        return torch.ones_like(s)
    s = torch.clamp_min(s, 1e-12)
    if robust == "huber":
        return torch.clamp_max(delta / torch.sqrt(s), 1.0)
    if robust == "dcs":
        phi = delta * delta
        return torch.clamp_max(2.0 * phi / (phi + s), 1.0)
    if robust == "tls":
        return (s <= delta * delta).to(s.dtype)
    raise ValueError(f"unknown robust loss {robust!r}")


def robust_cost(s, robust: Optional[str], delta: float):
    """rho(s): the robust cost whose IRLS weight is `robust_weight`."""
    if robust is None or robust == "none":
        return s
    s = torch.clamp_min(s, 0.0)
    if robust == "huber":
        rt = torch.sqrt(torch.clamp_min(s, 1e-12))
        return torch.where(rt <= delta, s, 2.0 * delta * rt - delta * delta)
    if robust == "dcs":
        phi = delta * delta
        return phi * s / (phi + s)
    if robust == "tls":
        return torch.clamp_max(s, delta * delta)
    raise ValueError(f"unknown robust loss {robust!r}")


def _weighted_blocks(poses, graph: PoseGraph, robust: Optional[str], delta: float):
    """(r, J_i, J_j, LJ_i, LJ_j, Lr) with L the robust-reweighted information."""
    r, J_i, J_j = _edge_jacobians(poses[graph.edge_i], poses[graph.edge_j], graph.meas)
    omega = robust_weight(_edge_sq_error(r, graph), robust, delta)  # [E]
    if graph.info is not None:
        L = graph.info * omega[:, None, None]
        LJ_i = _es("eab,ebc->eac", L, J_i)
        LJ_j = _es("eab,ebc->eac", L, J_j)
        Lr = _es("eab,eb->ea", L, r)
    else:
        w = (graph.weight * omega)[:, None, None]
        LJ_i, LJ_j = w * J_i, w * J_j
        Lr = (graph.weight * omega)[:, None] * r
    return r, J_i, J_j, LJ_i, LJ_j, Lr


def _assemble_normal_system(poses, graph: PoseGraph, robust: Optional[str], delta: float,
                            blocks: Segments, ends: Segments):
    """Dense H [6M, 6M], b [6M] from all edges. `blocks` lays out the 4E
    (row, col) blocks over the M*M block positions, `ends` the 2E edge
    ends over the M poses."""
    M = poses.shape[0]
    _, J_i, J_j, LJ_i, LJ_j, Lr = _weighted_blocks(poses, graph, robust, delta)
    Hii = _es("eba,ebc->eac", J_i, LJ_i)
    Hij = _es("eba,ebc->eac", J_i, LJ_j)
    Hji = Hij.transpose(-1, -2)
    Hjj = _es("eba,ebc->eac", J_j, LJ_j)
    bi = _es("eba,eb->ea", J_i, Lr)
    bj = _es("eba,eb->ea", J_j, Lr)
    Hblocks = segment_sum(torch.cat([Hii, Hij, Hji, Hjj], dim=0), blocks)  # [M*M, 6, 6]
    H = Hblocks.reshape(M, M, 6, 6).permute(0, 2, 1, 3).reshape(M * 6, M * 6)
    bvec = segment_sum(torch.cat([bi, bj], dim=0), ends).reshape(M * 6)
    return H, bvec


def _edge_blocks(poses, graph: PoseGraph, robust: Optional[str], delta: float, ends: Segments,
                 group=None):
    """Per-edge GN blocks for the matrix-free path: (J_i, J_j, LJ_i, LJ_j,
    b [M, 6], Pdiag [M, 6, 6]). Nothing [M, M]-shaped is built. With
    `group`, `graph` holds this rank's edge shard (poses replicated) and b,
    Pdiag are summed over the group."""
    _, J_i, J_j, LJ_i, LJ_j, Lr = _weighted_blocks(poses, graph, robust, delta)
    b = segment_sum(torch.cat([_es("eba,eb->ea", J_i, Lr), _es("eba,eb->ea", J_j, Lr)]), ends)
    Pdiag = segment_sum(torch.cat([_es("eba,ebc->eac", J_i, LJ_i),
                                   _es("eba,ebc->eac", J_j, LJ_j)]), ends)
    return J_i, J_j, LJ_i, LJ_j, all_reduce(b, group), all_reduce(Pdiag, group)


def _pgo_matvec(x, J_i, J_j, LJ_i, LJ_j, graph, lam, free, ends: Segments, group=None):
    """y = (H + lam I) x, gauge-projected: one edge stream and one segment
    sum (all-reduced under `group`, the only per-CG-step communication). On
    pinned coordinates the operator is the identity."""
    xm = x * free                                                      # [M, 6]
    u = _es("eab,eb->ea", LJ_i, xm[graph.edge_i]) + _es("eab,eb->ea", LJ_j, xm[graph.edge_j])
    y = segment_sum(torch.cat([_es("eba,eb->ea", J_i, u), _es("eba,eb->ea", J_j, u)]), ends)
    y = all_reduce(y, group)
    return (y + lam * xm) * free + (1.0 - free) * x


class PGOResult(NamedTuple):
    poses: torch.Tensor          # [M, 4, 4] optimized
    final_cost: torch.Tensor     # scalar: sum of (robust) weighted squared residuals
    initial_cost: torch.Tensor


def edge_errors(poses, graph: PoseGraph) -> torch.Tensor:
    """Per-edge weighted squared error s_e = r^T L r (or w |r|^2), [E]: the
    quantity `robust_weight` and `robust_cost` gate on."""
    r = edge_residual(poses[graph.edge_i], poses[graph.edge_j], graph.meas)
    return _edge_sq_error(r, graph)


def graph_cost(poses, graph: PoseGraph, robust: Optional[str] = None, delta: float = 1.0,
               group=None) -> torch.Tensor:
    r = edge_residual(poses[graph.edge_i], poses[graph.edge_j], graph.meas)
    return all_reduce(torch.sum(robust_cost(_edge_sq_error(r, graph), robust, delta)), group)


# Above this pose count optimize_pose_graph defaults to the matrix-free PCG
# solver: the dense [6M, 6M] assembly and solve are O(M^2) memory and
# O(M^3) work per step; the edge-streamed CG is O(E) per step.
DENSE_PGO_MAX_POSES = 64


def optimize_pose_graph(
    graph: PoseGraph,
    iters: int = 10,
    damping: float = 1e-6,
    robust: Optional[str] = None,
    delta: float = 1.0,
    solver: Optional[str] = None,
    cg_iters: int = 96,
    cg_tol: float = 1e-8,
    group=None,
) -> PGOResult:
    """Levenberg-Marquardt Gauss-Newton with the pose-0 gauge fix and a fixed
    iteration count.

    robust: None, "huber", "dcs" or "tls" (IRLS inside each step; the
    accept test uses the matching robust cost). solver: "dense", "pcg" or
    None (dense up to DENSE_PGO_MAX_POSES poses). group (pcg only): `graph`
    holds this rank's edge shard, poses replicated; costs and per-pose sums
    are all-reduced, so every rank follows the same LM schedule.

    A rejected step multiplies the damping by 10, an accepted one by 0.3
    (floored at `damping`).
    """
    M = graph.poses.shape[0]
    if solver is None:
        solver = "dense" if M <= DENSE_PGO_MAX_POSES else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if group is not None and solver != "pcg":
        raise ValueError("edge-sharded PGO requires solver='pcg'")
    dt, dev = graph.poses.dtype, graph.poses.device
    ei, ej = graph.edge_i.to(torch.int64), graph.edge_j.to(torch.int64)
    graph = graph._replace(edge_i=ei, edge_j=ej)
    ends = segments(torch.cat([ei, ej]), M)
    initial_cost = graph_cost(graph.poses, graph, robust, delta, group)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    if solver == "dense":
        blocks = segments(torch.cat([ei * M + ei, ei * M + ej, ej * M + ei, ej * M + ej]), M * M)
        free_d = (torch.arange(M * 6, device=dev) >= 6).to(dt)

        def solve(poses, lam):
            H, b = _assemble_normal_system(poses, graph, robust, delta, blocks, ends)
            # Gauge: pin pose 0 by masking its rows/cols with a unit diagonal.
            H = H * free_d[:, None] * free_d[None, :] + torch.diag(1.0 - free_d)
            b = b * free_d
            H = H + lam * torch.eye(M * 6, dtype=dt, device=dev)
            with full_fp32():
                return torch.linalg.solve(H, -b).reshape(M, 6)
    else:
        free = (torch.arange(M, device=dev) >= 1).to(dt)[:, None]            # [M, 1]

        def solve(poses, lam):
            J_i, J_j, LJ_i, LJ_j, b, Pdiag = _edge_blocks(poses, graph, robust, delta, ends,
                                                          group)
            Pdiag = Pdiag + lam * eye6[None]
            Pdiag = torch.where(free[:, :, None] > 0, Pdiag, eye6[None])
            with full_fp32():
                Pinv = torch.linalg.inv(Pdiag)

            def matvec(x):
                return _pgo_matvec(x, J_i, J_j, LJ_i, LJ_j, graph, lam, free, ends, group)

            def precond(x):
                return _es("mab,mb->ma", Pinv, x * free) + (1.0 - free) * x

            return cg(matvec, -b * free, cg_tol, cg_iters, precond) * free

    poses, cost = graph.poses, initial_cost
    lam = torch.tensor(damping, dtype=dt, device=dev)
    for _ in range(iters):
        dx = solve(poses, lam)
        new_poses = se3.compose(poses, se3.exp_se3(dx))
        new_cost = graph_cost(new_poses, graph, robust, delta, group)
        better = new_cost <= cost
        poses = torch.where(better, new_poses, poses)
        cost = torch.where(better, new_cost, cost)
        lam = torch.where(better, torch.clamp_min(lam * 0.3, damping), lam * 10.0)
    return PGOResult(poses=poses, final_cost=cost, initial_cost=initial_cost)


def odometry_chain_init(meas_odo: torch.Tensor) -> torch.Tensor:
    """Poses [M, 4, 4] from chaining consecutive measurements Z_{i,i+1}
    [M-1, 4, 4], with pose 0 the identity."""
    T = torch.eye(4, dtype=meas_odo.dtype, device=meas_odo.device)
    out = [T]
    for Z in meas_odo:
        T = se3.compose(T, Z)
        out.append(T)
    return torch.stack(out)
