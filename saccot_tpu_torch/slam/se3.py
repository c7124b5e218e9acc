"""Batched SE(3) Lie-group operations in PyTorch (float32, branchless).

Port of `saccot_tpu/slam/se3.py`: right-multiplicative increments
T <- T * exp(xi), twists ordered (v, w), Taylor-guarded closed forms, all
batched over leading dims. Every product runs in full FP32
(`utils/precision.mm`), as the JAX package pins `Precision.HIGHEST`:
reduced-precision rotations stall Gauss-Newton.
"""

from __future__ import annotations

import math

import torch

from saccot_tpu_torch.utils.precision import mm

# Taylor-guard threshold on theta^2: below theta = 0.1 the two-term series
# are accurate to ~1e-9 relative, while the closed forms cancel.
_EPS = 1e-2


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta2: torch.Tensor):
    """Taylor-guarded A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3."""
    small = theta2 < _EPS
    t2 = torch.where(small, 1.0, theta2)
    t = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(t)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (t - torch.sin(t)) / (t2 * t))
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, batched: [..., 3] -> [..., 3, 3]."""
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    A, B, _ = _sinc_coeffs(theta2)
    return _eye3(W) + A * W + B * mm(W, W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]; robust near 0, usable to ~pi - 1e-3.

    theta from atan2 of the antisymmetric part; near pi the axis is the
    best-conditioned column of R + I, signed along the antisymmetric part.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = 0.5 * torch.sqrt((v * v).sum(-1) + 1e-30)
    theta = torch.atan2(sin, cos)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0,
                        theta / (2.0 * torch.where(small, 1.0, sin)))
    w_generic = scale[..., None] * v
    C = R + torch.eye(3, dtype=R.dtype, device=R.device)
    j = torch.argmax(torch.diagonal(R, dim1=-2, dim2=-1), dim=-1)
    col = torch.gather(C, -1, j[..., None, None].expand(*C.shape[:-1], 1))[..., 0]
    axis = col / torch.clamp_min(torch.linalg.vector_norm(col, dim=-1, keepdim=True), 1e-12)
    s = torch.where((axis * v).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.where(near_pi[..., None], axis * s * theta[..., None], w_generic)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] (v, w) -> [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    A, B, C = _sinc_coeffs(theta2)
    I, WW = _eye3(W), mm(W, W)
    R = I + A * W + B * WW
    V = I + B * W + C * WW
    return pack(R, mm(V, v[..., None])[..., 0])


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> twist [..., 6] (v, w)."""
    w = log_so3(T[..., :3, :3])
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    A, B, _ = _sinc_coeffs(theta2)
    # V^-1 = I - W/2 + (1/t^2)(1 - A/(2B)) W^2, Taylor-guarded.
    small = theta2 < _EPS
    t2 = torch.where(small, 1.0, theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / t2)
    Vinv = _eye3(W) - 0.5 * W + coef * mm(W, W)
    return torch.cat([mm(Vinv, T[..., :3, 3:4])[..., 0], w], dim=-1)


def pack(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] + [..., 3] -> homogeneous [..., 4, 4]."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return pack(Rt, -mm(Rt, T[..., :3, 3:4])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return mm(A, B)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint [..., 6, 6] for the (v, w) twist order:
    Ad(T) = [[R, hat(t) R], [0, R]], so T exp(xi^) T^-1 = exp((Ad(T) xi)^)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, mm(hat(t), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] x [..., N, 3] -> [..., N, 3]."""
    return mm(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]
