"""Register a directory of scans as an odometry sequence (port of
`saccot_tpu/cli/sequence.py`).

Consecutive scans go through the registration pipeline: the repository's
native prefetch pool (native/prefetch.cpp) parses scans ahead while the
previous pair registers, each scan's features are computed once and reused
for both pairs it appears in (`features/pipeline.extract_scan_features`),
and the estimated relative transforms are chained into a trajectory (ATE
against KITTI-format ground truth when given). With loops, closures are
proposed from the trajectory, confirmed by registration and optimised as a
robust pose graph.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from saccot_tpu_torch.engine.sac_cot import RegistrationResult
from saccot_tpu_torch.evaluation.metrics import ate, registration_error
from saccot_tpu_torch.features.pipeline import (
    PipelineConfig, extract_scan_features, register_scan_features,
)
from saccot_tpu_torch.io import native
from saccot_tpu_torch.io.loaders import load_cloud, load_kitti_poses, pad_cloud
from saccot_tpu_torch.slam.frontend import edge_information, propose_loop_candidates
from saccot_tpu_torch.slam.posegraph import PoseGraph, edge_errors, optimize_pose_graph
from saccot_tpu_torch.utils.params import SacCotParams


def _find_scans(path: str, fmt: str) -> List[str]:
    if os.path.isdir(path):
        ext = {"kitti": "bin", "ply": "ply"}[fmt]
        paths = sorted(glob.glob(os.path.join(path, f"*.{ext}")))
    else:  # comma-separated explicit list
        paths = [p for p in path.split(",") if p]
    if len(paths) < 2:
        raise ValueError(f"need at least 2 scans, found {len(paths)} at {path!r}")
    return paths


def _scan_iter(paths: List[str], fmt: str, max_pts: int):
    """Native prefetching iterator when available, serial loads otherwise."""
    if fmt in ("kitti", "ply"):
        reader = native.prefetch_reader(paths, fmt, max_pts=max_pts)
        if reader is not None:
            return reader
    return (load_cloud(p)[:max_pts] for p in paths)


def default_sequence_config(metric_scale: float = 0.25) -> PipelineConfig:
    """Scene-scale defaults: thresholds in multiples of `metric_scale` (m)."""
    return PipelineConfig(
        voxel_mult=1.0,
        max_cloud_points=8192,
        iss_salient_mult=4.0, iss_nms_mult=3.0,
        descriptor="fpfh", descriptor_radius_mult=8.0, descriptor_k=48,
        max_keypoints=1024, max_correspondences=1024,
        compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
        estimator=SacCotParams(
            num_anchors=192, neighbors_per_anchor=12, max_hypotheses=1024,
        ),
        metric_scale=metric_scale,
    )


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _corr(res):
    """The correspondence sets, inliers and success of one registration."""
    return (_host(res.corr_P), _host(res.corr_Q), _host(res.registration.inliers),
            bool(res.registration.success))


def run_sequence_files(
    path: str,
    fmt: str = "kitti",
    poses_path: Optional[str] = None,
    cfg: Optional[PipelineConfig] = None,
    max_pts: int = 200_000,
    bucket: int = 65536,
    stride: int = 1,
    log=None,
    loops: bool = False,
    loop_radius: Optional[float] = None,
    loop_min_gap: int = 3,
    max_loops: int = 16,
    loop_min_inliers: int = 10,
    loop_gate: float = 1.0,
    pgo_iters: int = 12,
    device="cuda",
) -> Dict:
    """Odometry over a scan directory: consecutive registration + chaining.

    Returns aggregate metrics (per-pair records to `log` as JSONL). Poses
    follow target = T * source with source = scan i+stride, target = scan i,
    so chaining pose_{i+1} = pose_i @ T_i accumulates world-from-scan poses.

    With `loops=True`, loop-closure candidates are proposed from the chained
    trajectory's self-proximity (`slam/frontend.propose_loop_candidates`),
    each is confirmed or rejected by registering the pair from its cached
    per-scan features, and the odometry chain plus the confirmed loops are
    optimised as a robust pose graph (the TLS gate `loop_gate` cuts any
    confidently wrong closure). Adds `loop_closures` /
    `ate_rmse_optimized` to the metrics.
    """
    if cfg is None:
        cfg = default_sequence_config()
    paths = _find_scans(path, fmt)
    if stride > 1:
        paths = paths[::stride]

    gt_poses = load_kitti_poses(poses_path) if poses_path else None
    if gt_poses is not None and stride != 1:
        gt_poses = gt_poses[::stride]

    poses = [np.eye(4)]
    prev_feat = None
    times, rot_errs, trans_errs = [], [], []
    n_inliers = []
    feats = []       # per-scan features (kept only when loops=True)
    rel_meas = []    # odometry measurements Z_{i,i+1}
    corr = []        # per-edge (P, Q, inlier-mask, success) for info matrices
    t_start = time.perf_counter()
    scans = _scan_iter(paths, fmt, max_pts)
    try:
        for i, pts in enumerate(scans):
            if pts is None:
                raise IOError(f"unreadable scan: {paths[i]}")
            padded, mask = pad_cloud(pts.astype(np.float32), bucket)
            feat = extract_scan_features(padded, cfg, mask=mask, device=device)
            if loops:
                feats.append(feat)
            if prev_feat is not None:
                t0 = time.perf_counter()
                res = register_scan_features(feat, prev_feat, cfg)
                T = _host(res.registration.T).astype(np.float64)  # the copy waits
                times.append(time.perf_counter() - t0)
                poses.append(poses[-1] @ T)
                rel_meas.append(T)
                n_inliers.append(int(res.registration.num_inliers))
                if loops:
                    corr.append(_corr(res))
                rec = dict(
                    pair=(i - 1, i), wall_s=times[-1],
                    num_corr=int(res.num_correspondences),
                    num_inliers=n_inliers[-1],
                    success=bool(res.registration.success),
                )
                if gt_poses is not None and i < len(gt_poses):
                    # T maps scan i into scan i-1's frame, i.e. the GT
                    # relative pose inv(world_from_{i-1}) @ world_from_i.
                    T_gt = np.linalg.inv(gt_poses[i - 1]) @ gt_poses[i]
                    r, t = registration_error(T, T_gt)
                    rec["rot_err_deg"] = r
                    rec["trans_err"] = t
                    rot_errs.append(r)
                    trans_errs.append(t)
                if log:
                    log.log(rec)
            prev_feat = feat
    finally:
        close = getattr(scans, "close", None)
        if close:
            close()

    out: Dict = dict(
        scans=len(paths),
        pairs=len(times),
        mean_wall_s=float(np.mean(times[1:])) if len(times) > 1 else (times[0] if times else None),
        total_wall_s=time.perf_counter() - t_start,
        mean_inliers=float(np.mean(n_inliers)) if n_inliers else 0.0,
        native_prefetch=native.available(),
    )

    poses_opt = None
    if loops and len(poses) > loop_min_gap:
        poses_opt, loop_stats = _close_loops(
            poses, rel_meas, n_inliers, feats, cfg, corr,
            loop_radius=loop_radius, loop_min_gap=loop_min_gap,
            max_loops=max_loops, loop_min_inliers=loop_min_inliers,
            loop_gate=loop_gate, pgo_iters=pgo_iters, log=log, device=device,
        )
        out.update(loop_stats)

    if gt_poses is not None:
        n = min(len(poses), len(gt_poses))
        out["ate_rmse"] = ate(np.asarray(poses[:n]), np.asarray(gt_poses[:n]))["rmse"]
        if poses_opt is not None:
            out["ate_rmse_optimized"] = ate(
                np.asarray(poses_opt[:n]), np.asarray(gt_poses[:n])
            )["rmse"]
        if rot_errs:
            out["mean_rot_err_deg"] = float(np.mean(rot_errs))
            out["mean_trans_err"] = float(np.mean(trans_errs))
    final = poses_opt if poses_opt is not None else poses
    out["trajectory"] = [np.asarray(p)[:3, :].reshape(-1).tolist() for p in final]
    return out


def _close_loops(
    poses, rel_meas, n_inliers, feats, cfg, corr,
    loop_radius, loop_min_gap, max_loops, loop_min_inliers,
    loop_gate, pgo_iters, log=None, device="cuda",
):
    """Propose -> confirm -> robustly optimise loop closures.

    Edges carry [6, 6] information matrices from each registration's inlier
    statistics (`corr` holds the correspondence sets the main loop cached;
    `slam/frontend.edge_information`), so the residuals are chi^2_6-whitened
    and the robust losses' thresholds apply.

    Returns (optimised poses [M, 4, 4] float64, or None when no loop was
    confirmed; a stats dict).
    """
    poses_np = np.asarray(poses, np.float64)
    if loop_radius is None:
        steps = np.linalg.norm(
            poses_np[1:, :3, 3] - poses_np[:-1, :3, 3], axis=-1
        )
        # 5x the median step: candidates are confirmed by registration, so a
        # generous radius costs only compute (capped at max_loops), while a
        # tight one misses closures once the accumulated drift exceeds the
        # step size, which is where closures matter most.
        loop_radius = 5.0 * float(np.median(steps)) if len(steps) else 1.0
    cand = propose_loop_candidates(
        poses_np, min_gap=loop_min_gap, radius=loop_radius,
        max_candidates=max_loops,
    )

    loop_e, loop_Z, loop_w, loop_corr = [], [], [], []
    for (i, j) in cand:
        # Register scan j (src) against scan i (tgt): T maps j into i's
        # frame, which is the pose-graph measurement Z_ij = T_i^{-1} T_j.
        res = register_scan_features(feats[j], feats[i], cfg)
        ni = int(res.registration.num_inliers)
        ok = bool(res.registration.success) and ni >= loop_min_inliers
        if log:
            log.log(dict(loop_candidate=[int(i), int(j)],
                         num_inliers=ni, confirmed=ok))
        if ok:
            loop_e.append((int(i), int(j)))
            loop_Z.append(_host(res.registration.T).astype(np.float64))
            loop_w.append(float(ni))
            loop_corr.append(_corr(res))

    stats = dict(
        loop_candidates=len(cand),
        loop_closures=len(loop_e),
        loop_radius=float(loop_radius),
    )
    if not loop_e:
        return None, stats

    M = len(poses_np)
    mean_inl = max(float(np.mean(n_inliers)), 1.0)
    ei = list(range(M - 1)) + [e[0] for e in loop_e]
    ej = list(range(1, M)) + [e[1] for e in loop_e]
    meas = np.stack([np.asarray(Z, np.float64) for Z in rel_meas] + loop_Z)
    w = np.asarray(list(n_inliers) + loop_w, np.float64) / mean_inl

    # [E, 6, 6] information from the registrations' inlier statistics. The
    # measurement maps the edge's source scan (j) into the target's frame,
    # and edge_information is the Gauss-Newton information of exactly that
    # transform.
    dev = torch.device(device)
    all_corr = list(corr) + loop_corr
    E = len(ei)
    meas_f = torch.as_tensor(meas, dtype=torch.float32, device=dev)
    reg_b = RegistrationResult(
        R=meas_f[:, :3, :3],
        t=meas_f[:, :3, 3],
        T=meas_f,
        inliers=torch.as_tensor(np.stack([c[2] for c in all_corr]), device=dev),
        num_inliers=torch.as_tensor(list(n_inliers) + [int(x) for x in loop_w],
                                    dtype=torch.int32, device=dev),
        best_score=torch.zeros(E, dtype=torch.float32, device=dev),
        num_valid_triangles=torch.zeros(E, dtype=torch.int32, device=dev),
        success=torch.as_tensor([c[3] for c in all_corr], device=dev),
    )
    info = edge_information(
        reg_b,
        torch.as_tensor(np.stack([c[0] for c in all_corr]), dtype=torch.float32, device=dev),
        torch.as_tensor(np.stack([c[1] for c in all_corr]), dtype=torch.float32, device=dev),
    )
    graph = PoseGraph(
        poses=torch.as_tensor(poses_np, dtype=torch.float32, device=dev),
        edge_i=torch.as_tensor(ei, dtype=torch.int64, device=dev),
        edge_j=torch.as_tensor(ej, dtype=torch.int64, device=dev),
        meas=meas_f,
        weight=torch.as_tensor(w, dtype=torch.float32, device=dev),
        info=info,
    )
    # Two-stage robust schedule on chi^2_6-whitened residuals. A correct
    # loop closure's initial residual equals the accumulated odometry drift,
    # so a hard TLS gate up front would cut exactly the edge meant to correct
    # it. Stage 1: Huber, whose linear tail keeps a pull from every edge.
    # Stage 2: TLS at the chi^2_6 99% gate (delta ~ 4.1, valid because the
    # information matrices whiten the residuals), floored by twice the
    # post-Huber median so an uncalibrated noise model cannot cut half the
    # graph.
    pgo_h = optimize_pose_graph(graph, iters=pgo_iters, robust="huber", delta=3.0)
    s = _host(edge_errors(pgo_h.poses, graph)).astype(np.float64)
    med = float(np.median(np.sqrt(np.maximum(s, 0.0))))
    gate = max(4.1, 2.0 * med, float(loop_gate))
    pgo = optimize_pose_graph(
        graph._replace(poses=pgo_h.poses), iters=pgo_iters,
        robust="tls", delta=gate,
    )
    stats["pgo_initial_cost"] = float(pgo_h.initial_cost)
    stats["pgo_final_cost"] = float(pgo.final_cost)
    stats["tls_gate"] = gate
    return _host(pgo.poses).astype(np.float64), stats
