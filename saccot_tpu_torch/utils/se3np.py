"""NumPy SE(3) helpers of the synthetic problems, the metrics and the SLAM
dry runs (the port's own copy of the part of `saccot_tpu/utils/se3np.py`
they use)."""

from __future__ import annotations

import numpy as np


def hat(w: np.ndarray) -> np.ndarray:
    """Skew-symmetric matrix of a 3-vector (batched on leading dims)."""
    w = np.asarray(w)
    O = np.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype)
    O[..., 0, 1], O[..., 0, 2] = -w[..., 2], w[..., 1]
    O[..., 1, 0], O[..., 1, 2] = w[..., 2], -w[..., 0]
    O[..., 2, 0], O[..., 2, 1] = -w[..., 1], w[..., 0]
    return O


def exp_so3(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle 3-vector -> rotation matrix (batched)."""
    w = np.asarray(w, dtype=np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    W = hat(w)
    I = np.broadcast_to(np.eye(3), W.shape)
    small = th < 1e-8
    # Guard division; Taylor fallback for tiny angles.
    th_safe = np.where(small, 1.0, th)
    A = np.where(small, 1.0 - th**2 / 6.0, np.sin(th_safe) / th_safe)
    B = np.where(small, 0.5 - th**2 / 24.0, (1.0 - np.cos(th_safe)) / th_safe**2)
    return I + A * W + B * (W @ W)


def log_so3(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (batched)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)[..., None]
    v = np.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        axis=-1,
    )
    small = th < 1e-7
    th_safe = np.where(small, 1.0, th)
    scale = np.where(small, 0.5 + th**2 / 12.0, th / (2.0 * np.sin(th_safe)))
    # Near pi the v-based formula degrades; acceptable for test/gen usage where
    # angles are sampled away from pi. SLAM code uses its own robust log.
    return scale * v


def exp_se3(xi: np.ndarray) -> np.ndarray:
    """se(3) twist (v, w) -> 4x4 transform. xi[...,:3]=translation part, xi[...,3:]=rotation."""
    xi = np.asarray(xi, dtype=np.float64)
    v, w = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    W = hat(w)
    I = np.broadcast_to(np.eye(3), W.shape)
    small = th < 1e-8
    th_safe = np.where(small, 1.0, th)
    B = np.where(small, 0.5 - th**2 / 24.0, (1.0 - np.cos(th_safe)) / th_safe**2)
    C = np.where(small, 1.0 / 6.0 - th**2 / 120.0, (th_safe - np.sin(th_safe)) / th_safe**3)
    V = I + B * W + C * (W @ W)
    T = np.zeros(xi.shape[:-1] + (4, 4), dtype=np.float64)
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1.0
    return T


def make_T(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.zeros(R.shape[:-2] + (4, 4), dtype=np.float64)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inv_T(T: np.ndarray) -> np.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    return make_T(Rt, -np.einsum("...ij,...j->...i", Rt, t))


def apply_T(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ np.swapaxes(T[..., :3, :3], -1, -2) + T[..., None, :3, 3]


def rotation_angle_deg(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R, axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def rotation_distance_deg(R_a: np.ndarray, R_b: np.ndarray) -> np.ndarray:
    """Angle in degrees between two rotations, from |R_a - R_b|_F =
    2 sqrt(2) sin(angle / 2): exact near 0, where `rotation_angle_deg` of
    R_a R_b^T meets the float floor of the arccos of its trace."""
    d = np.linalg.norm(np.asarray(R_a, np.float64) - np.asarray(R_b, np.float64), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.minimum(1.0, d / (2.0 * np.sqrt(2.0)))))


def random_transform(rng: np.random.Generator, max_angle_rad: float = np.pi / 2,
                     max_trans: float = 1.0) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.1, max_angle_rad)
    t = rng.uniform(-max_trans, max_trans, size=3)
    return make_T(exp_so3(axis * angle), t)
