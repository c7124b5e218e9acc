"""Runners for the run configurations: make or load the data, run,
evaluate (port of `saccot_tpu/cli/runners.py`).

Each runner returns the JAX runner's metrics dict (and writes per-pair
JSONL records when given a logger). The data go to `device` ("cuda" unless
the caller asks for "cpu"); the estimator runs on the route `cfg.impl`
names (`configs.estimator_impl`). Every timed region ends in a host copy
of its result, which waits for the card, before the clock is read.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from saccot_tpu_torch.cli.configs import RunConfig, estimator_impl
from saccot_tpu_torch.engine.sac_cot import register_batch, register_pair
from saccot_tpu_torch.evaluation.metrics import (
    ate, is_registered, model_rmse, registration_error,
)
from saccot_tpu_torch.features.pipeline import (
    extract_scan_features, register_clouds, register_scan_features,
)
from saccot_tpu_torch.io.synthetic import (
    correspondence_problem, model_views, slam_sequence, two_view_pair,
)
from saccot_tpu_torch.slam.frontend import run_sequence
from saccot_tpu_torch.utils.checkpoint import SweepCheckpointer
from saccot_tpu_torch.utils.logging import JsonlLogger


def _host(x: torch.Tensor) -> np.ndarray:
    """A result on the host as float64: the copy waits for the card."""
    return x.detach().cpu().numpy().astype(np.float64)


def _pipe(cfg: RunConfig):
    return dataclasses.replace(cfg.pipeline, impl=estimator_impl(cfg.impl))


def _mean_wall(times):
    """The mean without the first call (kernel build and warm-up)."""
    return float(np.mean(times[1:])) if len(times) > 1 else times[0]


def run_pipeline_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                        device="cuda") -> Dict:
    """Configs 1-2: the whole cloud -> transform pipeline over synthetic view pairs."""
    ok, rot_errs, trans_errs, times = 0, [], [], []
    pipe = _pipe(cfg)
    for p in range(cfg.n_pairs):
        pair = two_view_pair(seed=cfg.seed + p, n_points=cfg.n_points,
                             overlap=cfg.overlap, noise=0.002)
        t0 = time.perf_counter()
        res = register_clouds(pair["source"], pair["target"], pipe, device=device)
        T = _host(res.registration.T)
        dt = time.perf_counter() - t0
        r, t = registration_error(T, pair["T_gt"])
        if cfg.use_model_rmse:
            # U3M protocol: model-point RMSE under T_est vs T_gt, in mesh-
            # resolution multiples.
            rmse = model_rmse(T, pair["T_gt"], pair["source"].astype(np.float64))
            hit = rmse < cfg.rmse_mult * float(res.resolution)
        else:
            rmse = None
            hit = is_registered(T, pair["T_gt"], cfg.rot_thresh_deg, cfg.trans_thresh)
        ok += hit
        rot_errs.append(r); trans_errs.append(t); times.append(dt)
        if log:
            log.log(dict(config=cfg.name, pair=p, rot_err_deg=r, trans_err=t,
                         model_rmse=rmse, registered=bool(hit), wall_s=dt,
                         num_corr=int(res.num_correspondences),
                         num_inliers=int(res.registration.num_inliers)))
    return dict(
        config=cfg.name, pairs=cfg.n_pairs, recall=ok / cfg.n_pairs,
        overlap=cfg.overlap,
        mean_rot_err_deg=float(np.mean(rot_errs)),
        mean_trans_err=float(np.mean(trans_errs)),
        mean_wall_s=_mean_wall(times),
    )


def run_sweep_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                     ckpt: Optional[str] = None, batch: int = 16,
                     fail_after_shard: Optional[int] = None, device="cuda") -> Dict:
    """Config 3: external correspondences, batched estimation, recall.

    `fail_after_shard` is the fault-injection hook: the process hard-exits
    (code 17) after checkpointing that shard, as a lost process would; a
    rerun with the same `ckpt` resumes from the shard boundary.
    """
    probs = [
        correspondence_problem(
            seed=cfg.seed + s, n=cfg.n_corr, outlier_ratio=cfg.outlier_ratio,
            noise=cfg.noise,
        )
        for s in range(cfg.n_pairs)
    ]
    P_all = torch.as_tensor(np.stack([p["P"] for p in probs]), device=device)
    Q_all = torch.as_tensor(np.stack([p["Q"] for p in probs]), device=device)
    impl = estimator_impl(cfg.impl)
    ckptr = SweepCheckpointer(ckpt)
    results_T = {}
    t_total, n_done = 0.0, 0
    # Warm up (kernel build, first launches) outside the timed loop, so
    # pairs_per_sec is the steady rate.
    warm = [0] * batch
    register_batch(P_all[warm], Q_all[warm], cfg.params, impl=impl).num_inliers.cpu()
    for s0 in range(0, cfg.n_pairs, batch):
        shard = s0 // batch
        rows = list(range(s0, min(s0 + batch, cfg.n_pairs)))
        rows += [rows[-1]] * (batch - len(rows))  # pad the last shard
        if ckptr.is_done(shard):
            T_all = ckptr.done[shard]["T"]
        else:
            t0 = time.perf_counter()
            res = register_batch(P_all[rows], Q_all[rows], cfg.params, impl=impl)
            T_all = _host(res.T)
            t_total += time.perf_counter() - t0
            n_done += batch
            ckptr.record(shard, dict(T=T_all))
            if fail_after_shard is not None and shard >= fail_after_shard:
                print(f"[fault-injection] exiting after shard {shard}", flush=True)
                os._exit(17)
        for b in range(batch):
            if s0 + b < cfg.n_pairs:
                results_T[s0 + b] = T_all[b]

    flags, rots, trans = [], [], []
    for idx, T in results_T.items():
        r, t = registration_error(T, probs[idx]["T_gt"])
        hit = is_registered(T, probs[idx]["T_gt"], cfg.rot_thresh_deg, cfg.trans_thresh)
        flags.append(hit); rots.append(r); trans.append(t)
        if log:
            log.log(dict(config=cfg.name, pair=idx, rot_err_deg=r, trans_err=t,
                         registered=bool(hit)))
    return dict(
        config=cfg.name, pairs=cfg.n_pairs, recall=float(np.mean(flags)),
        mean_rot_err_deg=float(np.mean(rots)), mean_trans_err=float(np.mean(trans)),
        pairs_per_sec=(n_done / t_total) if t_total > 0 else None,
    )


def run_kitti_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                     device="cuda") -> Dict:
    """Config 4: LiDAR-scale N (>= 50k) pairs, one `register_pair` each."""
    flags, rots, trans, times = [], [], [], []
    # Scene-scale spread (KITTI frames span ~100 m); cfg.noise is metric, so
    # the generator (unit-blob coordinates) gets noise / scale.
    scale = 30.0
    impl = estimator_impl(cfg.impl)
    for s in range(cfg.n_pairs):
        prob = correspondence_problem(
            seed=cfg.seed + s, n=cfg.n_corr, outlier_ratio=cfg.outlier_ratio,
            noise=cfg.noise / scale, n_points=4 * cfg.n_corr, max_angle=0.3,
            max_trans=3.0,
        )
        P = torch.as_tensor(prob["P"] * scale, device=device)
        Q = torch.as_tensor(prob["Q"] * scale, device=device)
        T_gt = prob["T_gt"].copy()
        T_gt[:3, 3] *= scale
        t0 = time.perf_counter()
        res = register_pair(P, Q, cfg.params, impl=impl)
        T = _host(res.T)
        dt = time.perf_counter() - t0
        r, t = registration_error(T, T_gt)
        hit = is_registered(T, T_gt, cfg.rot_thresh_deg, cfg.trans_thresh)
        flags.append(hit); rots.append(r); trans.append(t); times.append(dt)
        if log:
            log.log(dict(config=cfg.name, pair=s, n=cfg.n_corr, rot_err_deg=r,
                         trans_err=t, registered=bool(hit), wall_s=dt))
    return dict(
        config=cfg.name, pairs=cfg.n_pairs, n_corr=cfg.n_corr,
        recall=float(np.mean(flags)), mean_rot_err_deg=float(np.mean(rots)),
        mean_trans_err=float(np.mean(trans)),
        mean_wall_s=_mean_wall(times),
    )


def run_slam_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                    ckpt: Optional[str] = None, device="cuda") -> Dict:
    """Config 5: sequence SLAM: SAC-COT edges, pose graph, track BA, ATE.

    With `ckpt`, BA checkpoints every 2 Gauss-Newton iterations and a rerun
    resumes mid-solve (`utils/checkpoint.save_slam_state`).
    """
    seq = slam_sequence(
        seed=cfg.seed, n_scans=cfg.n_scans, n_corr=cfg.n_corr,
        outlier_ratio=cfg.outlier_ratio, noise=cfg.noise, loop_every=cfg.loop_every,
    )
    t0 = time.perf_counter()
    res = run_sequence(
        n_scans=cfg.n_scans, edges=seq["edges"], edge_P=seq["edge_P"],
        edge_Q=seq["edge_Q"], params=cfg.params,
        ckpt_path=ckpt, ba_ckpt_every=2 if ckpt else 0, log=log,
        impl=estimator_impl(cfg.impl), device=device,
    )
    poses = _host(res.poses)
    dt = time.perf_counter() - t0
    err_pgo = ate(_host(res.pose_graph_result.poses), seq["poses_gt"])
    err_final = ate(poses, seq["poses_gt"])
    out = dict(
        config=cfg.name, scans=cfg.n_scans, edges=int(seq["edges"].shape[0]),
        ate_rmse=err_final["rmse"], ate_rmse_pgo=err_pgo["rmse"],
        edges_registered=int(res.registration.success.sum()),
        wall_s=dt,
    )
    if res.ba_stats is not None:
        out["ba_tracks"] = res.ba_stats["n_tracks_kept"]
        out["ba_multiview_tracks"] = res.ba_stats["multiview_tracks"]
        out["ba_obs_truncated"] = res.ba_stats["n_obs_truncated"]
    if log:
        log.log(dict(**out))
    return out


OVERLAP_BANDS = ((0.0, 0.2), (0.2, 0.4), (0.4, 0.6), (0.6, 1.01))


def run_u3m_allpairs_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                            device="cuda") -> Dict:
    """Config 2: the complete V(V-1)/2 pairwise sweep over one model's view
    set, recall under the model-RMSE criterion.

    Views are index subsets of one shared model cloud
    (`io/synthetic.model_views`), so every pair's surface overlap is exact:
    |idx_i & idx_j| / min(|i|, |j|). Each view's features are extracted
    once and reused by the V-1 pairs it takes part in. Recall is reported
    over all pairs and over the pairs at or above the `overlap` threshold
    (low-overlap pairs are unregistrable in principle), with a
    recall-vs-overlap-band table.
    """
    mv = model_views(seed=cfg.seed, n_views=cfg.n_views,
                     n_points=cfg.n_points, noise=0.002)
    V = cfg.n_views
    pipe = _pipe(cfg)

    feats = [extract_scan_features(v, pipe, device=device) for v in mv["views"]]
    sets = [set(ix.tolist()) for ix in mv["idx"]]

    band_hit = [0] * len(OVERLAP_BANDS)
    band_tot = [0] * len(OVERLAP_BANDS)
    ok_all, n_all, ok_elig, n_elig = 0, 0, 0, 0
    times = []
    for i in range(V):
        for j in range(i + 1, V):
            ov = len(sets[i] & sets[j]) / max(min(len(sets[i]), len(sets[j])), 1)
            T_gt = mv["T"][j] @ np.linalg.inv(mv["T"][i])
            t0 = time.perf_counter()
            res = register_scan_features(feats[i], feats[j], pipe)
            T = _host(res.registration.T)
            times.append(time.perf_counter() - t0)
            rmse = model_rmse(T, T_gt, np.asarray(mv["views"][i], np.float64))
            hit = bool(rmse < cfg.rmse_mult * float(res.resolution))
            n_all += 1
            ok_all += hit
            if ov >= cfg.overlap:
                n_elig += 1
                ok_elig += hit
            for b, (lo, hi) in enumerate(OVERLAP_BANDS):
                if lo <= ov < hi:
                    band_tot[b] += 1
                    band_hit[b] += hit
            if log:
                log.log(dict(config=cfg.name, view_i=i, view_j=j,
                             overlap=round(ov, 3), model_rmse=float(rmse),
                             registered=hit))
    return dict(
        config=cfg.name, views=V, pairs=n_all,
        recall_all_pairs=ok_all / max(n_all, 1),
        eligible_pairs=n_elig,
        recall=ok_elig / max(n_elig, 1),
        overlap_threshold=cfg.overlap,
        recall_by_overlap_band={
            f"{lo:.1f}-{hi:.1f}": (band_hit[b] / band_tot[b] if band_tot[b] else None)
            for b, (lo, hi) in enumerate(OVERLAP_BANDS)
        },
        pairs_by_overlap_band={
            f"{lo:.1f}-{hi:.1f}": band_tot[b] for b, (lo, hi) in enumerate(OVERLAP_BANDS)
        },
        mean_wall_s=_mean_wall(times),
    )


RUNNERS = {
    "pipeline": run_pipeline_config,
    "u3m": run_u3m_allpairs_config,
    "sweep": run_sweep_config,
    "kitti": run_kitti_config,
    "slam": run_slam_config,
}


def run_config(cfg: RunConfig, **kw) -> Dict:
    return RUNNERS[cfg.kind](cfg, **kw)
