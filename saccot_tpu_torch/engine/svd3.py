"""Batched weighted rigid alignment (Horn quaternion method) — PyTorch.

Port of `saccot_tpu/engine/svd3.py`. The "quat" method (the default, and
the only one the estimator and the refine take) is Horn's; "svd" is the
reference's Procrustes cross-check, `torch.linalg.svd` of the jittered
cross-covariance with a branchless reflection fix. The quaternion
iteration runs in structure-of-arrays form over whatever batch shape its
inputs share, in exactly the order of the JAX function and of the fused CUDA
solve (`csrc/solve3.cu`). Sums over points are elementwise products and
sums, never a matmul, so TF32 cannot touch them. With a `group` the point
axis is sharded over it and every moment is summed over the group, as the
JAX function's `axis_name` psums them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from saccot_tpu_torch.dist.collectives import all_reduce


def quaternion_from_cross_covariance(Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz):
    """Optimal-rotation quaternion (qw, qx, qy, qz) of a cross-covariance.

    The dominant eigenvector of Horn's symmetric 4x4 matrix N(H), by a
    shift-and-square power method: A = N/|N|_F + 1.05 I, eight squarings with
    renormalisation, the largest column of A^256, two polish steps with the
    shifted original. Degenerate (near-collinear) inputs give an arbitrary
    member of the optimal set, as SVD would.
    """
    n00 = Sxx + Syy + Szz
    n01 = Syz - Szy
    n02 = Szx - Sxz
    n03 = Sxy - Syx
    n11 = Sxx - Syy - Szz
    n12 = Sxy + Syx
    n13 = Szx + Sxz
    n22 = Syy - Sxx - Szz
    n23 = Syz + Szy
    n33 = Szz - Sxx - Syy

    def fro2(a):
        d = a[0] * a[0] + a[4] * a[4] + a[7] * a[7] + a[9] * a[9]
        o = (a[1] * a[1] + a[2] * a[2] + a[3] * a[3]
             + a[5] * a[5] + a[6] * a[6] + a[8] * a[8])
        return d + 2.0 * o

    n = (n00, n01, n02, n03, n11, n12, n13, n22, n23, n33)
    inv_fro = 1.0 / (torch.sqrt(fro2(n)) + 1e-12)
    b = tuple(x * inv_fro for x in n)
    B = (b[0] + 1.05, b[1], b[2], b[3], b[4] + 1.05,
         b[5], b[6], b[7] + 1.05, b[8], b[9] + 1.05)

    def square_sym(a):
        a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = a
        return (
            a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03,
            a00 * a01 + a01 * a11 + a02 * a12 + a03 * a13,
            a00 * a02 + a01 * a12 + a02 * a22 + a03 * a23,
            a00 * a03 + a01 * a13 + a02 * a23 + a03 * a33,
            a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13,
            a01 * a02 + a11 * a12 + a12 * a22 + a13 * a23,
            a01 * a03 + a11 * a13 + a12 * a23 + a13 * a33,
            a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23,
            a02 * a03 + a12 * a13 + a22 * a23 + a23 * a33,
            a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33,
        )

    A = B
    for _ in range(8):  # A^256, renormalised against overflow
        A = square_sym(A)
        inv = 1.0 / (torch.sqrt(fro2(A)) + 1e-30)
        A = tuple(x * inv for x in A)

    a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = A
    cn0 = a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03
    cn1 = a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13
    cn2 = a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23
    cn3 = a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33
    cols = (
        (a00, a01, a02, a03),
        (a01, a11, a12, a13),
        (a02, a12, a22, a23),
        (a03, a13, a23, a33),
    )
    best_n, v = cn0, cols[0]
    for cn, col in ((cn1, cols[1]), (cn2, cols[2]), (cn3, cols[3])):
        take = cn > best_n
        best_n = torch.where(take, cn, best_n)
        v = tuple(torch.where(take, cj, vj) for cj, vj in zip(col, v))

    b00, b01, b02, b03, b11, b12, b13, b22, b23, b33 = B
    for _ in range(2):  # polish with the shifted original
        v0, v1, v2, v3 = v
        w0 = b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3
        w1 = b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3
        w2 = b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3
        w3 = b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3
        inv = 1.0 / (torch.sqrt(w0 * w0 + w1 * w1 + w2 * w2 + w3 * w3) + 1e-30)
        v = (w0 * inv, w1 * inv, w2 * inv, w3 * inv)
    return v


def rotation_entries_from_quaternion(qw, qx, qy, qz):
    """Unit quaternion (SoA) -> the 9 rotation-matrix entries, row-major."""
    return (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy),
    )


def umeyama(
    p: torch.Tensor,
    q: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    group=None,
    method: str = "quat",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment, batched over leading dims.

    Minimises sum_i w_i |R p_i + t - q_i|^2. p, q: [..., M, 3]; w: [..., M]
    (default uniform). An all-zero weight row gives a finite rotation.
    `group`: the M axis is this rank's shard; the moments are summed over
    the group, so every rank gets the global fit. method: "quat" (Horn's
    iteration) or "svd" (Procrustes, for cross-checking). Returns
    R [..., 3, 3], t [..., 3].
    """
    if method not in ("quat", "svd"):
        raise ValueError(f"method must be 'quat' or 'svd', got {method!r}")
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = w.to(p.dtype)
    wsum = torch.clamp_min(all_reduce(w.sum(dim=-1, keepdim=True), group), 1e-9)  # [..., 1]
    pbar = all_reduce((w[..., None] * p).sum(dim=-2), group) / wsum               # [..., 3]
    qbar = all_reduce((w[..., None] * q).sum(dim=-2), group) / wsum
    pc = p - pbar[..., None, :]
    qc = q - qbar[..., None, :]
    wpc = w[..., None] * pc
    H = [(wpc[..., a] * qc[..., c]).sum(dim=-1) for a in range(3) for c in range(3)]
    if group is not None:
        H = all_reduce(torch.stack(H, dim=-1), group).unbind(-1)
    if method == "svd":
        R = _procrustes_rotation(torch.stack(H, dim=-1).reshape(*H[0].shape, 3, 3))
        r = R.reshape(*R.shape[:-2], 9).unbind(-1)
    else:
        r = rotation_entries_from_quaternion(*quaternion_from_cross_covariance(*H))
        R = torch.stack(r, dim=-1).reshape(*r[0].shape, 3, 3)
    t = torch.stack(
        [qbar[..., c] - (r[3 * c] * pbar[..., 0] + r[3 * c + 1] * pbar[..., 1]
                         + r[3 * c + 2] * pbar[..., 2]) for c in range(3)],
        dim=-1,
    )
    return R, t


def _procrustes_rotation(H: torch.Tensor) -> torch.Tensor:
    """R = V diag(1, 1, det(V U^T)) U^T of the cross-covariance H [..., 3, 3]
    (U S V^T = H + 1e-12 I; the jitter keeps an exactly degenerate H, such
    as a padded hypothesis of identical points, well defined)."""
    U, _, Vh = torch.linalg.svd(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device),
                                full_matrices=False)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    s = torch.sign(torch.linalg.det(V @ Ut))
    s = torch.where(s == 0, 1.0, s).to(H.dtype)
    V = torch.cat([V[..., :2], V[..., 2:] * s[..., None, None]], dim=-1)
    return V @ Ut


def transform_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack [..., 3, 3] + [..., 3] into homogeneous [..., 4, 4]."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T
