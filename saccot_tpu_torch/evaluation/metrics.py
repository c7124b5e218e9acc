"""Registration criteria and trajectory errors (the port's own copy of
`registration_error`, `is_registered`, `registration_recall`, `ate` and
`relative_pose_error` from `saccot_tpu/evaluation/metrics.py`).

A pair counts as registered when its rotation error and translation error
are both under the criterion; recall is the registered fraction. `ate`
aligns an estimated trajectory to the truth and reports the position
error; `relative_pose_error` the drift over pose increments.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from saccot_tpu_torch.utils import se3np


def registration_error(T_est: np.ndarray, T_gt: np.ndarray) -> Tuple[float, float]:
    """(rotation error deg, translation error) of T_est vs T_gt."""
    E = np.asarray(T_est, np.float64) @ np.linalg.inv(np.asarray(T_gt, np.float64))
    return float(se3np.rotation_angle_deg(E[:3, :3])), float(np.linalg.norm(E[:3, 3]))


def is_registered(
    T_est: np.ndarray,
    T_gt: np.ndarray,
    rot_thresh_deg: float = 15.0,
    trans_thresh: float = 0.30,
) -> bool:
    r, t = registration_error(T_est, T_gt)
    return (r < rot_thresh_deg) and (t < trans_thresh)


def registration_recall(
    results: Iterable[Tuple[np.ndarray, np.ndarray]],
    rot_thresh_deg: float = 15.0,
    trans_thresh: float = 0.30,
) -> float:
    """Fraction of (T_est, T_gt) pairs meeting the criterion."""
    flags = [is_registered(e, g, rot_thresh_deg, trans_thresh) for e, g in results]
    return float(np.mean(flags)) if flags else 0.0


def ate(
    traj_est: np.ndarray,
    traj_gt: np.ndarray,
    align: bool = True,
) -> Dict[str, float]:
    """Absolute trajectory error of [M, 4, 4] pose arrays.

    Umeyama-aligns estimated positions to GT (rotation+translation, no
    scale) when `align`, then reports RMSE / mean / max position error.
    """
    p = np.asarray(traj_est, np.float64)[:, :3, 3]
    g = np.asarray(traj_gt, np.float64)[:, :3, 3]
    if align and p.shape[0] >= 3:
        mu_p, mu_g = p.mean(0), g.mean(0)
        H = (p - mu_p).T @ (g - mu_g)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        t = mu_g - R @ mu_p
        p = p @ R.T + t
    err = np.linalg.norm(p - g, axis=-1)
    return dict(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()),
        max=float(err.max()),
    )


def relative_pose_error(
    traj_est: np.ndarray, traj_gt: np.ndarray, delta: int = 1
) -> Dict[str, float]:
    """RPE over pose increments of stride `delta` (odometry drift metric)."""
    e = np.asarray(traj_est, np.float64)
    g = np.asarray(traj_gt, np.float64)
    M = e.shape[0]
    rot, trans = [], []
    for i in range(M - delta):
        de = np.linalg.inv(e[i]) @ e[i + delta]
        dg = np.linalg.inv(g[i]) @ g[i + delta]
        r, t = registration_error(de, dg)
        rot.append(r)
        trans.append(t)
    return dict(
        rot_mean_deg=float(np.mean(rot)) if rot else 0.0,
        trans_rmse=float(np.sqrt(np.mean(np.square(trans)))) if trans else 0.0,
    )
