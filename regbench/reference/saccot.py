"""The plain reference of the SAC-COT estimator, in plain PyTorch.

A frozen copy of the algorithm that `saccot_tpu_torch.engine.sac_cot.
register_batch` computes (on one process, every stage on its plain route):
compatibility degrees, the exact triangle pool, the 3-point solves, the
hypotheses' inlier counts, the first-maximum best hypothesis and the
weighted-Umeyama refine; `check_supported` refuses the settings that no
configuration uses (weighted scores, the fast pool, dedup off, the ring).
It imports nothing of the program and takes only the points, the mask and
the configuration's parameters (a dict of `SacCotParams`' fields).

`dtype` sets the precision of every floating-point value: float32 is the
configuration's precision; a lower one (bfloat16) gives the control of the
comparison that decides `correct`. Sums over points are elementwise
products and sums, never a matmul, so TF32 cannot touch them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# Elements of one [batch, rows, cols] block of the degrees.
_BLOCK_ELEMS = 2 ** 25
# Above this many points the pool scores candidates from the neighbours'
# coordinates instead of the fused anchor rows (the program's route split;
# both give the same candidates).
_MAX_N_FUSED = 4096


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lowest index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def check_supported(prm: Dict) -> None:
    """Refuse the settings this reference does not compute: it holds the
    exact pool (dedup on, exact top-K, no per-anchor candidates) scored by
    counts, on one process."""
    wanted = {"scoring": "count", "dedup_triangles": True, "approx_topk": False,
              "per_anchor_candidates": 0, "ring_compat": False}
    other = {k: prm.get(k) for k, v in wanted.items() if prm.get(k) != v}
    if other:
        raise ValueError(f"the reference computes {wanted}, not {other}")


# --- compatibility -------------------------------------------------------

def _cross_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., R, 3] x [..., C, 3] -> distances [..., R, C] by direct
    differences, ((dx*dx + dy*dy) + dz*dz) then the root."""
    d = [a[..., :, None, c] - b[..., None, :, c] for c in range(3)]
    return torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def _pair_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def _pair_score(dp, dq, tau: float, min_sep: float):
    """s = (|dp-dq| < tau and min(dp, dq) > min_sep) ? 1 - |dp-dq| / tau : 0."""
    delta = torch.abs(dp - dq)
    ok = (delta < tau) & (torch.minimum(dp, dq) > min_sep)
    return torch.where(ok, 1.0 - delta * (1.0 / tau), 0.0).to(dp.dtype)


def degrees(P, Q, prm: Dict, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """deg[b, i] = sum over j != i of the compatibility of (i, j), in row
    blocks of the virtual N x N matrix."""
    batch, N, _ = P.shape
    rows = max(1, min(N, _BLOCK_ELEMS // max(1, batch * N)))
    cols = torch.arange(N, device=P.device)
    out = []
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        S = _pair_score(_cross_distances(P[:, r0:r1], P), _cross_distances(Q[:, r0:r1], Q),
                        prm["compat_tau"], prm["min_separation"])
        S = torch.where(cols[r0:r1, None] == cols[None, :], 0.0, S).to(S.dtype)
        if mask is not None:
            S = S * mask[:, r0:r1, None] * mask[:, None, :]
        out.append(S.sum(dim=-1))
    return torch.cat(out, dim=1)


# --- triangle pool -------------------------------------------------------

def _gather_rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X [batch, N, 3], idx [batch, ...] -> [batch, ..., 3]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(X, 1, flat[..., None].expand(*flat.shape, 3))
    return out.reshape(*idx.shape, 3)


def _anchor_neighbors(P, Q, anchors, B: int, prm: Dict, mask, anchor_mask):
    """Each anchor's B strongest edges: (scores, node ids) [batch, A, B]."""
    N = P.shape[1]
    S = _pair_score(_cross_distances(_gather_rows(P, anchors), P),
                    _cross_distances(_gather_rows(Q, anchors), Q),
                    prm["compat_tau"], prm["min_separation"])          # [batch, A, N]
    S = torch.where(anchors[..., None] == torch.arange(N, device=P.device), 0.0, S).to(S.dtype)
    if mask is not None:
        S = S * mask[:, None, :]
        S = S * anchor_mask[:, :, None]
    return topk_stable(S, B)


def _candidate_grid(nbr_s, nbr_p, nbr_q, prm: Dict) -> torch.Tensor:
    """[batch, A, B, B] candidate scores (s_b1 + s_b2) + s_b1b2 where
    b1 < b2 and all three edges are positive, -1 elsewhere."""
    B = nbr_s.shape[-1]
    s_jk = _pair_score(_pair_distances(nbr_p[:, :, :, None], nbr_p[:, :, None, :]),
                       _pair_distances(nbr_q[:, :, :, None], nbr_q[:, :, None, :]),
                       prm["compat_tau"], prm["min_separation"])
    s1, s2 = nbr_s[..., :, None], nbr_s[..., None, :]
    upper = torch.ones(B, B, dtype=torch.bool, device=nbr_s.device).triu(1)
    valid = (s1 > 0) & (s2 > 0) & (s_jk > 0) & upper
    return torch.where(valid, s1 + s2 + s_jk, -1.0).to(nbr_s.dtype)


def _duplicates(anchors, nbr_idx, nbr_valid, b1, b2, n_nodes: int) -> torch.Tensor:
    """Exact dedup mask [batch, A, Pairs]: a triangle enters once per vertex
    that is an anchor holding the other two among its valid neighbours; the
    copy at the smallest anchor slot is kept."""
    batch, A, B = nbr_idx.shape
    slot_of = torch.full((batch, n_nodes), -1, dtype=torch.int64, device=anchors.device)
    slot_of.scatter_(1, anchors, torch.arange(A, device=anchors.device).expand(batch, A))
    x = torch.gather(slot_of, 1, nbr_idx.reshape(batch, A * B)).reshape(batch, A, B)
    match = (x >= 0) & nbr_valid
    rows = x.clamp_min(0).reshape(batch, A * B, 1).expand(batch, A * B, B)
    R3 = torch.gather(nbr_idx, 1, rows).reshape(batch, A, B, B)
    V3 = torch.gather(nbr_valid, 1, rows).reshape(batch, A, B, B) & match[..., None]
    holds_a = ((R3 == anchors[:, :, None, None]) & V3).any(dim=-1)
    earlier = x < torch.arange(A, device=x.device)[None, :, None]
    gate = match & earlier & holds_a
    in_row = ((R3[..., :, None] == nbr_idx[:, :, None, None, :])
              & V3[..., :, None]).any(dim=-2)
    return (gate[:, :, b1] & in_row[:, :, b1, b2]) | (gate[:, :, b2] & in_row[:, :, b2, b1])


def _select(cols, score, K: int):
    """The top-K of a flat candidate list, padded to K with (0, 0, 0) and -1."""
    top_s, top_i = topk_stable(score, min(K, score.shape[1]))
    triples = torch.stack([torch.gather(c, 1, top_i) for c in cols], dim=-1)
    pad = K - top_s.shape[1]
    if pad > 0:
        triples = torch.cat([triples, triples.new_zeros((triples.shape[0], pad, 3))], dim=1)
        top_s = torch.cat([top_s, top_s.new_full((top_s.shape[0], pad), -1.0)], dim=1)
    return triples, top_s > 0


def triangle_pool(P, Q, deg, prm: Dict, mask):
    """Ranked triangles of the exact pool: every candidate of every anchor,
    each triangle once (dedup), the top-K. (triples [batch, K, 3] int64,
    valid [batch, K])."""
    batch, N, _ = P.shape
    A = min(prm["num_anchors"], N)
    B = min(prm["neighbors_per_anchor"], N - 1)
    K = prm["max_hypotheses"]
    _, anchors = topk_stable(deg, A)
    anchor_mask = None if mask is None else torch.gather(mask, 1, anchors)
    nbr_s, nbr_idx = _anchor_neighbors(P, Q, anchors, B, prm, mask, anchor_mask)
    cand3 = _candidate_grid(nbr_s, _gather_rows(P, nbr_idx), _gather_rows(Q, nbr_idx), prm)
    b1, b2 = (torch.as_tensor(x, device=P.device) for x in np.triu_indices(B, k=1))
    cand = cand3[:, :, b1, b2]
    i = anchors[:, :, None].expand(batch, A, b1.shape[0]).reshape(batch, -1)
    j = nbr_idx[:, :, b1].reshape(batch, -1)
    k = nbr_idx[:, :, b2].reshape(batch, -1)
    if N > _MAX_N_FUSED:
        # The scores from the neighbours' coordinates also test i != j etc.
        cand = torch.where((i != j) & (i != k) & (j != k),
                           cand.reshape(batch, -1), -1.0).to(cand.dtype).reshape(cand.shape)
    dup = _duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2, N)
    cand = torch.where(dup, -1.0, cand).to(cand.dtype).reshape(batch, -1)
    a0, b0 = torch.minimum(i, j), torch.maximum(i, j)
    lo2, hi = torch.minimum(b0, k), torch.maximum(b0, k)
    lo, mid = torch.minimum(a0, lo2), torch.maximum(a0, lo2)
    return _select((lo, mid, hi), cand, K)


# --- rigid fits ----------------------------------------------------------

def _horn_quaternion(Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz):
    """The optimal-rotation quaternion of a cross-covariance: the dominant
    eigenvector of Horn's symmetric 4x4 matrix by a shift-and-square power
    method (eight renormalised squarings, the largest column, two polish
    steps with the shifted matrix)."""
    n = (Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx, Sxx - Syy - Szz, Sxy + Syx,
         Szx + Sxz, Syy - Sxx - Szz, Syz + Szy, Szz - Sxx - Syy)

    def fro2(a):
        d = a[0] * a[0] + a[4] * a[4] + a[7] * a[7] + a[9] * a[9]
        o = (a[1] * a[1] + a[2] * a[2] + a[3] * a[3]
             + a[5] * a[5] + a[6] * a[6] + a[8] * a[8])
        return d + 2.0 * o

    def square(a):
        a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = a
        return (a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03,
                a00 * a01 + a01 * a11 + a02 * a12 + a03 * a13,
                a00 * a02 + a01 * a12 + a02 * a22 + a03 * a23,
                a00 * a03 + a01 * a13 + a02 * a23 + a03 * a33,
                a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13,
                a01 * a02 + a11 * a12 + a12 * a22 + a13 * a23,
                a01 * a03 + a11 * a13 + a12 * a23 + a13 * a33,
                a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23,
                a02 * a03 + a12 * a13 + a22 * a23 + a23 * a33,
                a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33)

    inv = 1.0 / (torch.sqrt(fro2(n)) + 1e-12)
    b = [x * inv for x in n]
    for d in (0, 4, 7, 9):
        b[d] = b[d] + 1.05
    A = tuple(b)
    for _ in range(8):
        A = square(A)
        inv = 1.0 / (torch.sqrt(fro2(A)) + 1e-30)
        A = tuple(x * inv for x in A)
    a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = A
    cols = ((a00, a01, a02, a03), (a01, a11, a12, a13), (a02, a12, a22, a23),
            (a03, a13, a23, a33))
    norms = [c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + c[3] * c[3] for c in cols]
    best, v = norms[0], cols[0]
    for cn, col in zip(norms[1:], cols[1:]):
        take = cn > best
        best = torch.where(take, cn, best)
        v = tuple(torch.where(take, c, x) for c, x in zip(col, v))
    b00, b01, b02, b03, b11, b12, b13, b22, b23, b33 = b
    for _ in range(2):
        v0, v1, v2, v3 = v
        w = (b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3,
             b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3,
             b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3,
             b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3)
        inv = 1.0 / (torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + w[3] * w[3]) + 1e-30)
        v = tuple(x * inv for x in w)
    return v


def _rotation_entries(qw, qx, qy, qz):
    """Unit quaternion -> the 9 rotation-matrix entries, row-major."""
    return (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy),
            2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
            2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy))


def _translation(r, pbar, qbar):
    return torch.stack([qbar[..., c] - (r[3 * c] * pbar[..., 0] + r[3 * c + 1] * pbar[..., 1]
                                        + r[3 * c + 2] * pbar[..., 2]) for c in range(3)], dim=-1)


def solve3(P, Q, triples):
    """The rigid fit of each triple: R [batch, K, 3, 3], t [batch, K, 3]."""
    p = _gather_rows(P, triples)                              # [batch, K, 3, 3]
    q = _gather_rows(Q, triples)
    third = 1.0 / 3.0
    pbar = (p[:, :, 0] + p[:, :, 1] + p[:, :, 2]) * third
    qbar = (q[:, :, 0] + q[:, :, 1] + q[:, :, 2]) * third
    pc, qc = p - pbar[:, :, None], q - qbar[:, :, None]
    H = [pc[:, :, 0, a] * qc[:, :, 0, c] + pc[:, :, 1, a] * qc[:, :, 1, c]
         + pc[:, :, 2, a] * qc[:, :, 2, c] for a in range(3) for c in range(3)]
    r = _rotation_entries(*_horn_quaternion(*H))
    R = torch.stack(r, dim=-1).reshape(*r[0].shape, 3, 3)
    return R, _translation(r, pbar, qbar)


def umeyama(p, q, w):
    """Weighted rigid fit over the point axis: p, q [batch, N, 3], w
    [batch, N] -> R [batch, 3, 3], t [batch, 3]."""
    wsum = torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    pbar = (w[..., None] * p).sum(dim=-2) / wsum
    qbar = (w[..., None] * q).sum(dim=-2) / wsum
    pc, qc = p - pbar[..., None, :], q - qbar[..., None, :]
    wpc = w[..., None] * pc
    H = [(wpc[..., a] * qc[..., c]).sum(dim=-1) for a in range(3) for c in range(3)]
    r = _rotation_entries(*_horn_quaternion(*H))
    R = torch.stack(r, dim=-1).reshape(*r[0].shape, 3, 3)
    return R, _translation(r, pbar, qbar)


# --- scores and the refine -----------------------------------------------

def _residual(R, t, P, Q):
    """x[..., n, c] = (t_c - q_nc) + R[c,0] p_n0 + R[c,1] p_n1 + R[c,2] p_n2."""
    cols = []
    for c in range(3):
        x = t[..., None, c] - Q[..., c]
        for j in range(3):
            x = x + R[..., None, c, j] * P[..., j]
        cols.append(x)
    return torch.stack(cols, dim=-1)


def score(R, t, P, Q, tau: float, mask, block_k: int = 256):
    """Scores [batch, K] of K hypotheses against the N points: the inlier
    count, |residual|^2 < tau^2."""
    K = R.shape[1]
    live = None if mask is None else mask[:, None, :] > 0
    out = []
    for k0 in range(0, K, block_k):
        x = _residual(R[:, k0:k0 + block_k], t[:, k0:k0 + block_k], P[:, None], Q[:, None])
        d2 = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]
        inl = d2 < tau * tau
        if live is not None:
            inl = inl & live
        out.append(inl.sum(dim=-1).to(torch.float32))
    return torch.cat(out, dim=1)


def inlier_mask(R, t, P, Q, tau: float, mask):
    x = _residual(R, t, P, Q)
    inl = torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]) < tau
    return inl if mask is None else inl & (mask > 0)


def register(P: torch.Tensor, Q: torch.Tensor, prm: Dict,
             mask: Optional[torch.Tensor] = None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The estimator on P, Q [batch, N, 3] (mask [batch, N]) in `dtype`:
    R [batch, 3, 3], t [batch, 3], num_inliers [batch] int64, best_score
    [batch] float32 (the winning hypothesis's score before the refine),
    num_valid_triangles [batch] int64 and success [batch] bool."""
    check_supported(prm)
    P, Q = P.to(dtype), Q.to(dtype)
    batch, N, _ = P.shape
    m = None if mask is None else mask.to(dtype)
    deg = degrees(P, Q, prm, m)
    triples, valid = triangle_pool(P, Q, deg, prm, m)
    Rh, th = solve3(P, Q, triples)
    s = score(Rh, th, P, Q, prm["inlier_tau"], m)
    s = torch.where(valid, s, -1.0)
    best = torch.argmax(s, dim=1)                                # first maximum
    rows = torch.arange(batch, device=P.device)
    best_score = s[rows, best]
    R, t = Rh[rows, best], th[rows, best]
    w_mask = torch.ones((batch, N), dtype=dtype, device=P.device) if m is None else m
    inl = inlier_mask(R, t, P, Q, prm["inlier_tau"], m)
    for _ in range(prm["refine_iters"]):
        w = inl.to(dtype) * w_mask
        Rf, tf = umeyama(P, Q, w)
        keep = w.sum(dim=1) >= 3.0
        R = torch.where(keep[:, None, None], Rf, R)
        t = torch.where(keep[:, None], tf, t)
        inl = inlier_mask(R, t, P, Q, prm["inlier_tau"], m)
    success = valid.any(dim=1)
    eye = torch.eye(3, dtype=dtype, device=P.device)
    R = torch.where(success[:, None, None], R, eye)
    t = torch.where(success[:, None], t, 0.0).to(dtype)
    inl = inl & success[:, None]
    return dict(R=R, t=t, num_inliers=inl.sum(dim=1), best_score=best_score,
                num_valid_triangles=valid.sum(dim=1), success=success)
