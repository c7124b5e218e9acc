"""Closed-form symmetric 3x3 eigendecomposition, batched and branchless.

Port of `saccot_tpu/features/eig3.py`: the trigonometric (Cardano) solution
for the spectrum, and the eigenvector of a simple eigenvalue as the
largest-norm cross product of two rows of the shifted, normalised matrix,
with the same sign conventions and the same isotropic guard. Not
`torch.linalg.eigh`: the consumers' thresholds and the normals' signs are
tuned to this form.
"""

from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def _normalized_form(C: torch.Tensor):
    """B = (C - q I) / p with q = tr/3, p = sqrt(tr((C-qI)^2)/6).

    Returns (B entries..., q, p, iso); iso flags (near-)isotropic matrices
    (p ~ 0: all eigenvalues equal q), whose B is meaningless.
    """
    a, b, c = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    d, e, f = C[..., 0, 1], C[..., 1, 2], C[..., 0, 2]
    q = (a + b + c) / 3.0
    p1 = d * d + e * e + f * f
    p2 = (a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2.0 * p1
    iso = p2 <= 1e-30
    p = torch.sqrt(torch.where(iso, 1.0, p2) / 6.0)
    inv_p = 1.0 / p
    Bd = ((a - q) * inv_p, (b - q) * inv_p, (c - q) * inv_p, d * inv_p, e * inv_p, f * inv_p)
    return Bd, q, torch.where(iso, 0.0, p), iso


def _beta_angles(Bd):
    """phi such that the normalised eigenvalues are 2cos(phi + {0,2pi/3,4pi/3})."""
    B00, B11, B22, B01, B12, B02 = Bd
    detB = (B00 * (B11 * B22 - B12 * B12)
            - B01 * (B01 * B22 - B12 * B02)
            + B02 * (B01 * B12 - B11 * B02))
    return torch.acos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0


def eigvals3_sym(C: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending [..., 3]."""
    Bd, q, p, _ = _normalized_form(C)
    phi = _beta_angles(Bd)
    e1 = q + 2.0 * p * torch.cos(phi)                # largest
    e3 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)    # smallest
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1], dim=-1)


def _nullspace_vec(Bd, beta):
    """Largest-norm row-pair cross of (B - beta I): spans the 1-D null
    space of a simple eigenvalue's shifted matrix. Returns (v, norm2)."""
    B00, B11, B22, B01, B12, B02 = Bd
    r0 = torch.stack([B00 - beta, B01, B02], dim=-1)
    r1 = torch.stack([B01, B11 - beta, B12], dim=-1)
    r2 = torch.stack([B02, B12, B22 - beta], dim=-1)
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01, n02, n12 = (c01 * c01).sum(-1), (c02 * c02).sum(-1), (c12 * c12).sum(-1)
    best12 = n12 >= torch.maximum(n01, n02)
    best02 = n02 >= n01
    v = torch.where(best12[..., None], c12, torch.where(best02[..., None], c02, c01))
    return v, torch.maximum(torch.maximum(n01, n02), n12)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-30))


def _axis(like: torch.Tensor, i: int) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def extreme_eigvecs3_sym(C: torch.Tensor):
    """(v_small, v_large): unit eigenvectors of the smallest and largest
    eigenvalues of symmetric [..., 3, 3], the two axes SHOT's local
    reference frame takes.

    Degenerate spectra fall back to a fixed orthonormal pair; v_large is
    re-orthogonalised against v_small so the frame stays orthonormal.
    """
    Bd, q, p, iso = _normalized_form(C)
    phi = _beta_angles(Bd)
    vs, ns = _nullspace_vec(Bd, 2.0 * torch.cos(phi + _TWO_PI_3))   # smallest
    vl, nl = _nullspace_vec(Bd, 2.0 * torch.cos(phi))               # largest

    ez, ex = _axis(vs, 2), _axis(vs, 0)
    vs = _unit(torch.where(((ns <= 1e-20) | iso)[..., None], ez, vs))
    vl = torch.where(((nl <= 1e-20) | iso)[..., None], ex, vl)
    vl = vl - (vl * vs).sum(-1, keepdim=True) * vs
    deg = (vl * vl).sum(-1) <= 1e-20
    alt = torch.linalg.cross(vs, ez, dim=-1)
    alt_ok = (alt * alt).sum(-1) > 1e-12
    fallback = torch.where(alt_ok[..., None], alt, torch.linalg.cross(vs, ex, dim=-1))
    vl = _unit(torch.where(deg[..., None], fallback, vl))
    return vs, vl


def smallest_eigvec3_sym(C: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue, [..., 3]: the null
    space of B - beta3 I (the normalised form), the largest of the three
    row-pair crosses; a (near-)isotropic or degenerate neighbourhood falls
    back to e_z."""
    Bd, q, p, iso = _normalized_form(C)
    v, nv = _nullspace_vec(Bd, 2.0 * torch.cos(_beta_angles(Bd) + _TWO_PI_3))
    return _unit(torch.where(((nv <= 1e-20) | iso)[..., None], _axis(v, 2), v))
