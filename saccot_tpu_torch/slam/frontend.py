"""SLAM front end: pairwise SAC-COT edges -> pose graph -> optional BA.

Port of `saccot_tpu/slam/frontend.py`, the flow of the slam configuration:

  1. register every sequence edge (odometry and loop closures) with one
     `register_batch` call (the estimator's four kernels on the card);
  2. turn the per-edge transforms into pose-graph measurements with
     information matrices from the inlier statistics; chain the odometry
     for the initial guess;
  3. Gauss-Newton pose-graph optimization (`slam/posegraph.py`);
  4. optionally merge the inlier correspondences into multi-view landmark
     tracks (host-side NumPy) and run Schur-complement bundle adjustment
     (`slam/ba.py`).

Each stage of `run_sequence` runs in a profiler range named STAGE_PREFIX +
<stage> (register, graph, pgo, tracks, ba), which
`utils.profile.profile_call(..., ranges=STAGE_PREFIX)` reads. The slam run
configuration of the JAX package's CLI (`cli/configs.py` "slam") is
restated at the end (`SLAM_PARAMS`, `slam_config_sequence`).

Frame conventions: `register_pair(P_i, Q_j)` returns M with q ~= M p (p in
scan i's frame, q in scan j's). With poses T_i: world <- scan, a shared
point satisfies p_j = T_j^{-1} T_i p_i, so the pose-graph measurement
Z_ij = T_i^{-1} T_j = M^{-1}. Every product, information matrix and normal
equation runs in full FP32 (`utils/precision`).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from saccot_tpu_torch.engine.sac_cot import RegistrationResult, register_batch
from saccot_tpu_torch.io.synthetic import slam_sequence
from saccot_tpu_torch.slam import se3
from saccot_tpu_torch.slam.ba import BAProblem, BAResult, _residuals, ba_cost, bundle_adjust
from saccot_tpu_torch.slam.posegraph import (
    PGOResult, PoseGraph, odometry_chain_init, optimize_pose_graph,
)
from saccot_tpu_torch.utils.checkpoint import restore, save_slam_state
from saccot_tpu_torch.utils.params import SacCotParams
from saccot_tpu_torch.utils.precision import einsum as _es

# The profiler ranges of run_sequence's stages are named STAGE_PREFIX + <stage>.
STAGE_PREFIX = "slam/"


def _stage(name: str):
    return record_function(STAGE_PREFIX + name)


class SequenceResult(NamedTuple):
    poses: torch.Tensor               # [M, 4, 4] final trajectory
    pose_graph_result: PGOResult
    registration: RegistrationResult  # batched per-edge results
    ba_result: Optional[BAResult]
    num_failed_edges: int             # edges below min_inliers / unsuccessful
    ba_stats: Optional[Dict] = None   # track-association stats (truncation etc.)


def edge_information(
    reg: RegistrationResult,     # batched over E
    edge_P: torch.Tensor,        # [E, N, 3] source points (frame i)
    edge_Q: torch.Tensor,        # [E, N, 3] target points (frame j)
    sigma_floor: float = 1e-3,
) -> torch.Tensor:
    """[E, 6, 6] information matrices from the estimator's inlier statistics.

    First-order propagation of the registration's Gauss-Newton information
    for a right perturbation of the estimated transform:

        H = (1/sigma^2) sum_n w_n [[I,        -hat(p_n)     ],
                                   [hat(p_n), |p_n|^2 I - p_n p_n^T]]

    with sigma^2 the per-coordinate residual variance (the weighted mean of
    |r|^2 over 3), floored at sigma_floor^2. Only three inlier moments are
    needed (sum w, sum w p, sum w p p^T). Edges that failed or have fewer
    than 3 inliers get a tiny isotropic information.
    """
    P = edge_P.to(torch.float32)
    Q = edge_Q.to(torch.float32)
    w = reg.inliers.to(torch.float32)                    # [E, N]

    x = _es("eij,enj->eni", reg.R, P) + reg.t[:, None, :] - Q
    d2 = torch.sum(x * x, dim=-1)                        # [E, N]
    S0 = torch.sum(w, dim=-1)                            # [E]
    sigma2 = torch.sum(w * d2, dim=-1) / (3.0 * torch.clamp_min(S0, 1.0))
    sigma2 = torch.clamp_min(sigma2, sigma_floor ** 2)   # [E]

    S1 = _es("en,eni->ei", w, P)                         # [E, 3]
    S2 = _es("en,eni,enj->eij", w, P, P)                 # [E, 3, 3]
    eye3 = torch.eye(3, dtype=P.dtype, device=P.device)

    tl = S0[:, None, None] * eye3                        # [E, 3, 3]
    tr = -se3.hat(S1)
    br = torch.diagonal(S2, dim1=-2, dim2=-1).sum(-1)[:, None, None] * eye3 - S2
    H = torch.cat([
        torch.cat([tl, tr], dim=-1),
        torch.cat([-tr, br], dim=-1),
    ], dim=-2) / sigma2[:, None, None]                   # [E, 6, 6]

    ok = (reg.success & (S0 >= 3.0))[:, None, None]
    tiny = 1e-6 * torch.eye(6, dtype=P.dtype, device=P.device).expand(H.shape)
    return torch.where(ok, H, tiny)


def registrations_to_graph(
    n_scans: int,
    edges: torch.Tensor,         # [E, 2] (i, j)
    reg: RegistrationResult,     # batched over E
    min_inliers: int = 5,
    edge_P: Optional[torch.Tensor] = None,
    edge_Q: Optional[torch.Tensor] = None,
) -> PoseGraph:
    """A PoseGraph from batched edge registrations.

    With `edge_P`/`edge_Q`, full [E, 6, 6] information matrices come from
    the inlier statistics (`edge_information`), transported to the graph
    residual's frame; otherwise the edge weight is the inlier count. Failed
    edges get weight ~0. The first n_scans - 1 edges must be the odometry
    chain, in order: they give the initial guess.
    """
    Z = se3.inv(reg.T)  # measurement T_i^{-1} T_j (see module docstring)
    ok = reg.success & (reg.num_inliers >= min_inliers)
    w = torch.where(ok, reg.num_inliers.to(torch.float32), 1e-6)

    info = None
    if edge_P is not None and edge_Q is not None:
        dev = reg.T.device
        info = edge_information(reg, torch.as_tensor(edge_P, device=dev),
                                torch.as_tensor(edge_Q, device=dev))
        # The estimator's H whitens a right perturbation of T_est; the graph
        # residual perturbs Z = inv(T_est): H_r = Ad(Z)^T H Ad(Z).
        Ad = se3.adjoint(Z)
        info = _es("eba,ebc,ecd->ead", Ad, info, Ad)
        info = torch.where(ok[:, None, None], info,
                           1e-6 * torch.eye(6, dtype=info.dtype, device=dev).expand(info.shape))

    poses0 = odometry_chain_init(Z[: n_scans - 1])
    edges = torch.as_tensor(edges, device=reg.T.device)
    return PoseGraph(
        poses=poses0,
        edge_i=edges[:, 0].to(torch.int64),
        edge_j=edges[:, 1].to(torch.int64),
        meas=Z,
        weight=w,
        info=info,
    )


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def correspondences_to_ba(
    poses,                         # [M, 4, 4] pose-graph output (tensor or array)
    edges: np.ndarray,             # [E, 2]
    edge_P: np.ndarray,            # [E, N, 3] points in frame i
    edge_Q: np.ndarray,            # [E, N, 3] points in frame j
    inliers: np.ndarray,           # [E, N] bool from registration
    max_landmarks: int = 2048,
    obs_per_landmark: int = 8,
    merge_cell: float = 0.02,
    min_track_obs: int = 2,
    mode: str = "tracks",
    device=None,
) -> Tuple[BAProblem, Dict]:
    """Associate inlier correspondences into multi-view landmark tracks.

    Host-side NumPy, the JAX package's function line for line. Every inlier
    correspondence gives two observations of one point (in scan i at P, in
    scan j at Q); observations from different edges are merged into one
    track by voxel-hashing their world-frame estimates under `poses` (cell
    `merge_cell`). Tracks are ranked by observation count (truncation to
    `max_landmarks` drops the least constrained); within a track, slots
    prefer distinct poses. mode="pairwise" keeps each correspondence as its
    own landmark.

    Returns (BAProblem on `device`: by default `poses`' device, the card
    for an array; stats) with stats keys n_obs, n_tracks_raw,
    n_tracks_kept, n_tracks_dropped, n_obs_truncated, multiview_tracks,
    max_track_obs.
    """
    if device is None:
        device = poses.device if isinstance(poses, torch.Tensor) else "cuda"
    poses_np = np.asarray(_host(poses), np.float64)
    edges = np.asarray(edges)
    E, N = inliers.shape
    G = obs_per_landmark
    L = max_landmarks

    # World-frame estimate of every observation under the current poses.
    Ri = poses_np[edges[:, 0], :3, :3]  # [E, 3, 3]
    ti = poses_np[edges[:, 0], :3, 3]
    Rj = poses_np[edges[:, 1], :3, :3]
    tj = poses_np[edges[:, 1], :3, 3]
    wP = np.einsum("eab,enb->ena", Ri, np.asarray(edge_P, np.float64)) + ti[:, None]
    wQ = np.einsum("eab,enb->ena", Rj, np.asarray(edge_Q, np.float64)) + tj[:, None]

    valid = np.asarray(inliers, bool).reshape(-1)
    pose_id = np.concatenate([
        np.repeat(edges[:, 0], N), np.repeat(edges[:, 1], N)
    ])[np.concatenate([valid, valid])]
    z_loc = np.concatenate([
        np.asarray(edge_P, np.float32).reshape(-1, 3)[valid],
        np.asarray(edge_Q, np.float32).reshape(-1, 3)[valid],
    ])
    w_pt = np.concatenate([
        wP.reshape(-1, 3)[valid], wQ.reshape(-1, 3)[valid]
    ])
    n_obs = w_pt.shape[0]

    prob_out = functools.partial(
        _pack_ba_problem, poses=poses_np, L=L, G=G, device=device
    )
    if n_obs == 0:
        return prob_out(None, None, None, None), dict(
            n_obs=0, n_tracks_raw=0, n_tracks_kept=0, n_tracks_dropped=0,
            n_obs_truncated=0, multiview_tracks=0, max_track_obs=0,
        )

    if mode == "pairwise":
        # Each correspondence is its own landmark: the track key is the
        # correspondence's flat index.
        key = np.concatenate([np.arange(valid.size)] * 2)[
            np.concatenate([valid, valid])
        ]
    else:
        # Voxel hash -> track ids. 21 bits per axis around a 2^20 offset
        # covers +-1e6 cells per dimension.
        q = np.floor(w_pt / merge_cell).astype(np.int64) + (1 << 20)
        key = q[:, 0] | (q[:, 1] << 21) | (q[:, 2] << 42)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)

    # Keep the best-constrained tracks: count desc, >= min_track_obs.
    order = np.argsort(-counts, kind="stable")
    keep = order[counts[order] >= min_track_obs][:L]
    n_kept = len(keep)
    rank = np.full(len(uniq), -1, np.int64)
    rank[keep] = np.arange(n_kept)
    tr = rank[inv]  # per-observation track slot, -1 = dropped track

    sel = np.nonzero(tr >= 0)[0]
    # Prefer distinct poses within a track: stable-sort observations by
    # (track, first-observation-of-this-pose? 0 : 1), then take the first G
    # per track.
    by_tp = sel[np.lexsort((pose_id[sel], tr[sel]))]
    first = np.ones(len(by_tp), bool)
    first[1:] = (tr[by_tp][1:] != tr[by_tp][:-1]) | (
        pose_id[by_tp][1:] != pose_id[by_tp][:-1]
    )
    so = by_tp[np.lexsort(((~first).astype(np.int8), tr[by_tp]))]
    t_sorted = tr[so]
    group_sizes = np.bincount(t_sorted, minlength=n_kept)
    starts = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    slot = np.arange(len(so)) - starts[t_sorted]
    take = slot < G

    obs_pose = np.zeros((L, G), np.int32)
    obs_z = np.zeros((L, G, 3), np.float32)
    obs_w = np.zeros((L, G), np.float32)
    ti_, si_ = t_sorted[take], slot[take]
    obs_pose[ti_, si_] = pose_id[so[take]]
    obs_z[ti_, si_] = z_loc[so[take]]
    obs_w[ti_, si_] = 1.0

    # Landmark init: mean world-frame estimate over the kept observations.
    landmarks = np.zeros((L, 3), np.float32)
    acc = np.zeros((L, 3), np.float64)
    np.add.at(acc, ti_, w_pt[so[take]])
    cnt = np.bincount(ti_, minlength=L).astype(np.float64)
    landmarks[:n_kept] = (
        acc[:n_kept] / np.maximum(cnt[:n_kept], 1.0)[:, None]
    ).astype(np.float32)

    # Distinct poses per kept track (for the multiview stat): `first` marks
    # the first observation of each (track, pose) run in by_tp order.
    distinct = np.bincount(tr[by_tp[first]], minlength=n_kept)
    stats = dict(
        n_obs=int(n_obs),
        n_tracks_raw=int((counts >= min_track_obs).sum()),
        n_tracks_kept=int(n_kept),
        n_tracks_dropped=int((counts >= min_track_obs).sum() - n_kept),
        n_obs_truncated=int((~take).sum()),
        multiview_tracks=int((distinct >= 3).sum()),
        max_track_obs=int(counts.max()) if len(counts) else 0,
    )
    return prob_out(landmarks, obs_pose, obs_z, obs_w), stats


def _pack_ba_problem(landmarks, obs_pose, obs_z, obs_w, *, poses, L, G, device):
    if landmarks is None:
        landmarks = np.zeros((L, 3), np.float32)
        obs_pose = np.zeros((L, G), np.int32)
        obs_z = np.zeros((L, G, 3), np.float32)
        obs_w = np.zeros((L, G), np.float32)
    return BAProblem(
        poses=torch.as_tensor(np.asarray(poses, np.float32), device=device),
        landmarks=torch.as_tensor(landmarks, device=device),
        obs_pose=torch.as_tensor(obs_pose.astype(np.int64), device=device),
        obs_z=torch.as_tensor(obs_z, device=device),
        obs_w=torch.as_tensor(obs_w, device=device),
    )


def propose_loop_candidates(
    poses: np.ndarray,
    min_gap: int = 3,
    radius: float = 1.0,
    max_candidates: int = 32,
) -> np.ndarray:
    """Loop-closure candidates by trajectory proximity (host-side).

    After odometry chaining, scans whose estimated positions fall within
    `radius` of each other but are at least `min_gap` apart in time are
    candidate loop closures (SURVEY.md section 3.5, "odometry + loop
    candidates") — the registration engine then confirms or rejects each by
    actually registering the pair. Returns [C, 2] (i, j) with i < j, closest
    first, capped at max_candidates.
    """
    t = np.asarray(poses, np.float64)[:, :3, 3]  # [M, 3]
    d = np.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
    M = t.shape[0]
    ii, jj = np.triu_indices(M, k=min_gap)
    sel = d[ii, jj] < radius
    ii, jj = ii[sel], jj[sel]
    order = np.argsort(d[ii, jj], kind="stable")[:max_candidates]
    return np.stack([ii[order], jj[order]], axis=1).astype(np.int64)


def run_sequence(
    n_scans: int,
    edges: np.ndarray,
    edge_P: np.ndarray,
    edge_Q: np.ndarray,
    params: SacCotParams,
    pgo_iters: int = 10,
    run_ba: bool = True,
    ba_iters: int = 5,
    max_landmarks: int = 2048,
    use_info: bool = True,
    robust: Optional[str] = "huber",
    robust_delta: float = 3.0,
    obs_per_landmark: int = 8,
    merge_cell: Optional[float] = None,
    ckpt_path: Optional[str] = None,
    ba_ckpt_every: int = 0,
    log=None,
    impl: str = "kernel",
    device="cuda",
) -> SequenceResult:
    """Sequence SLAM on one device: `device` ("cuda" by default, "cpu" on
    request) takes the edges' correspondence sets; `impl` routes the
    estimator ("kernel": the CUDA kernels on the card; "plain").

    use_info derives [E, 6, 6] information matrices from the inlier
    statistics; robust selects the pose-graph loss ("huber", "dcs" or None)
    with threshold `robust_delta` on the whitened residual. BA runs on
    multi-view landmark tracks (voxel-merge cell `merge_cell`, by default 3x
    the estimator's inlier threshold) with up to `obs_per_landmark`
    observations each, under a Huber gate of twice the median initial track
    residual.

    Checkpoint/resume: with `ckpt_path`, BA runs in chunks of
    `ba_ckpt_every` iterations (0 = one chunk), saving (poses, landmarks,
    gn_iter, lam) after each; a rerun with the same arguments restores the
    iterate and the LM damping and continues where the interrupted run
    stopped, so it ends where the uninterrupted run ends.
    """
    dev = torch.device(device)
    P = torch.as_tensor(np.asarray(edge_P), device=dev)
    Q = torch.as_tensor(np.asarray(edge_Q), device=dev)
    with _stage("register"):
        reg = register_batch(P, Q, params, impl=impl)
    with _stage("graph"):
        graph = registrations_to_graph(
            n_scans, torch.as_tensor(np.asarray(edges), device=dev), reg,
            edge_P=P if use_info else None,
            edge_Q=Q if use_info else None,
        )
    with _stage("pgo"):
        pgo = optimize_pose_graph(graph, iters=pgo_iters, robust=robust, delta=robust_delta)
    n_failed = int((~(reg.success & (reg.num_inliers >= 5))).sum())

    ba_res = None
    ba_stats = None
    poses = pgo.poses
    if run_ba:
        if merge_cell is None:
            merge_cell = 3.0 * float(params.inlier_tau)
        # Data-scaled Huber gate: 2x the median initial track residual
        # (landmarks start at their track means, so the initial |r| measures
        # the intra-track spread).
        ba_robust = None
        with _stage("tracks"):
            prob, ba_stats = correspondences_to_ba(
                pgo.poses, edges, edge_P, edge_Q, _host(reg.inliers),
                max_landmarks=max_landmarks, obs_per_landmark=obs_per_landmark,
                merge_cell=merge_cell, device=dev,
            )
            r0, _ = _residuals(prob.poses, prob.landmarks, prob)
            d0 = np.sqrt(np.sum(_host(r0).astype(np.float64) ** 2, axis=-1))
            real = _host(prob.obs_w) > 0
            if real.any():
                ba_robust = max(2.0 * float(np.median(d0[real])), 1e-9)
            ba_stats["huber_delta"] = ba_robust
        if log is not None:
            log.log(dict(event="ba_tracks", **ba_stats))

        with _stage("ba"):
            done, lam = 0, None
            if ckpt_path:
                st = restore(ckpt_path)
                if st is not None and int(st.get("gn_iter", 0)) > 0:
                    done = min(int(st["gn_iter"]), ba_iters)
                    prob = prob._replace(
                        poses=torch.as_tensor(np.asarray(st["poses"], np.float32), device=dev),
                        landmarks=torch.as_tensor(np.asarray(st["landmarks"], np.float32),
                                                  device=dev),
                    )
                    if "lam" in st:
                        lam = torch.tensor(float(np.asarray(st["lam"])), dtype=torch.float32,
                                           device=dev)
            while done < ba_iters:
                chunk = (ba_iters - done if ba_ckpt_every <= 0
                         else min(ba_ckpt_every, ba_iters - done))
                ba_res = bundle_adjust(prob, iters=chunk, lam0=lam, robust_delta=ba_robust)
                prob = prob._replace(poses=ba_res.poses, landmarks=ba_res.landmarks)
                lam = ba_res.lam
                done += chunk
                if ckpt_path:
                    save_slam_state(ckpt_path, ba_res.poses, ba_res.landmarks,
                                    gn_iter=done, lam=float(lam))
            if ba_res is None:
                # The checkpoint's gn_iter already equals ba_iters: BA finished
                # in an earlier run. The result is the restored state.
                c = ba_cost(prob.poses, prob.landmarks, prob, robust_delta=ba_robust)
                ba_res = BAResult(
                    poses=prob.poses, landmarks=prob.landmarks, initial_cost=c, final_cost=c,
                    lam=torch.tensor(0.0 if lam is None else float(lam), dtype=torch.float32,
                                     device=dev),
                )
        poses = prob.poses
    return SequenceResult(
        poses=poses,
        pose_graph_result=pgo,
        registration=reg,
        ba_result=ba_res,
        num_failed_edges=n_failed,
        ba_stats=ba_stats,
    )


# The slam run configuration (`saccot_tpu/cli/configs.py` "slam"): 10 scans,
# odometry plus a loop closure every 3 scans and one from the last scan to
# the first (13 edges), 512 correspondences an edge at 50% outliers; its
# runner calls run_sequence with the defaults above.
SLAM_SEED = 700
SLAM_SCANS = 10
SLAM_CORR = 512
SLAM_OUTLIERS = 0.5
SLAM_NOISE = 0.004
SLAM_LOOP_EVERY = 3
SLAM_PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.08, inlier_tau=0.03,
    num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
)
SLAM_ATE_BOUND = 0.05  # final ATE bound of tests/test_slam.py's end-to-end run


def slam_config_sequence(n_scans: int = SLAM_SCANS) -> Dict[str, np.ndarray]:
    """The slam configuration's sequence (`slam_sequence` NumPy arrays), at
    `n_scans` scans (the configuration's 10 unless asked otherwise)."""
    return slam_sequence(seed=SLAM_SEED, n_scans=n_scans, n_corr=SLAM_CORR,
                         outlier_ratio=SLAM_OUTLIERS, noise=SLAM_NOISE,
                         loop_every=SLAM_LOOP_EVERY)
