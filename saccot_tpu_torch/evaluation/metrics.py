"""Registration criteria (the port's own copy of `registration_error`,
`is_registered` and `registration_recall` from
`saccot_tpu/evaluation/metrics.py`).

A pair counts as registered when its rotation error and translation error
are both under the criterion; recall is the registered fraction.
"""

from __future__ import annotations

from typing import Iterable, Tuple

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
