"""Batched ICP: a dense-cloud polish of a SAC-COT initial transform.

Port of `saccot_tpu/engine/icp.py`, written over a leading batch of pairs
(`icp` is a batch of one). A fixed number of iterations; each finds every
source point's nearest target by a blocked brute-force Gram product (FP32,
first minimum on ties), weights the matches (source mask, distance gate,
optional trimming to the closest `trim_frac`), and updates T:
  - point-to-point: the weighted Horn fit of the original source to the
    matched targets (`engine/svd3.umeyama`);
  - point-to-plane: one damped Gauss-Newton step on n . (T p - q), a 6 x 6
    solve, applied on the manifold (`slam/se3.exp_se3`).
Fewer than 3 weighted matches hold T; a non-finite step is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from saccot_tpu_torch.engine.svd3 import transform_from_rt, umeyama
from saccot_tpu_torch.features.neighbors import gram3, sq_norms, sqrt_rn
from saccot_tpu_torch.slam import se3
from saccot_tpu_torch.utils.precision import mm


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Static ICP configuration (the JAX package's fields and defaults)."""

    max_iters: int = 20
    # Matches farther than this get weight 0 (metric units; <= 0 disables).
    max_corr_dist: float = 0.1
    # Trimmed ICP: keep only the closest trim_frac of matched points each
    # iteration (1.0 = classic ICP).
    trim_frac: float = 1.0
    # "point" (point-to-point, Horn) or "plane" (point-to-plane, GN).
    variant: str = "point"
    # Levenberg damping on the 6x6 point-to-plane normal equations.
    plane_damping: float = 1e-6
    # Source-block size for the blockwise NN search (memory knob only).
    nn_block_rows: int = 512

    def __post_init__(self):
        if not (0.0 < self.trim_frac <= 1.0):
            raise ValueError("trim_frac must be in (0, 1]")
        if self.variant not in ("point", "plane"):
            raise ValueError(f"unknown ICP variant: {self.variant!r}")
        if self.max_iters < 1:
            raise ValueError("max_iters must be >= 1")


class IcpResult(NamedTuple):
    T: torch.Tensor            # [..., 4, 4] refined transform (tgt <- src)
    R: torch.Tensor            # [..., 3, 3]
    t: torch.Tensor            # [..., 3]
    rmse: torch.Tensor         # [...] weighted inlier RMSE at T
    rmse_trace: torch.Tensor   # [..., max_iters] RMSE after each update; [-1] == rmse
    num_matched: torch.Tensor  # [...] int32: weight-positive matches under T


def nearest_neighbors(
    src: torch.Tensor,
    tgt: torch.Tensor,
    mask_tgt: Optional[torch.Tensor] = None,
    block_rows: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force NN of each src point in tgt, blockwise over src rows.

    src [..., N, 3], tgt [..., M, 3] -> (idx [..., N] int64, dist [..., N]).
    Masked-out targets are never selected.
    """
    t2 = sq_norms(tgt, fused=False)
    if mask_tgt is not None:
        t2 = torch.where(mask_tgt.to(torch.bool), t2, torch.inf)
    idx, dist = [], []
    for start in range(0, src.shape[-2], block_rows):
        sb = src[..., start:start + block_rows, :]
        d2 = sq_norms(sb, fused=True)[..., :, None] + t2[..., None, :] - 2.0 * gram3(sb, tgt)
        dmin, i = torch.min(d2, dim=-1)        # the first minimum
        idx.append(i)
        dist.append(sqrt_rn(torch.clamp_min(dmin, 0.0)))
    return torch.cat(idx, dim=-1), torch.cat(dist, dim=-1)


def _match_weights(dist: torch.Tensor, mask_src: Optional[torch.Tensor],
                   params: IcpParams) -> torch.Tensor:
    """Per-match weights [..., N]: source mask x distance gate x trim gate."""
    w = torch.ones_like(dist)
    if mask_src is not None:
        w = w * mask_src.to(dist.dtype)
    if params.max_corr_dist > 0:
        w = w * (dist < params.max_corr_dist).to(dist.dtype)
    if params.trim_frac < 1.0:
        n_keep = max(3, int(round(params.trim_frac * dist.shape[-1])))
        # The n_keep-th smallest eligible distance (a value: ties cannot
        # change it); ineligible matches are +inf and never define the cut.
        gated = torch.where(w > 0, dist, torch.inf)
        thresh = torch.kthvalue(gated, n_keep, dim=-1, keepdim=True).values
        w = w * (gated <= thresh).to(dist.dtype)
    return w


def icp_batch(
    src: torch.Tensor,
    tgt: torch.Tensor,
    params: IcpParams,
    T_init: Optional[torch.Tensor] = None,
    mask_src: Optional[torch.Tensor] = None,
    mask_tgt: Optional[torch.Tensor] = None,
    tgt_normals: Optional[torch.Tensor] = None,
) -> IcpResult:
    """Refine rigid transforms on a batch of cloud pairs: src [B, N, 3],
    tgt [B, M, 3], T_init [B, 4, 4] (identity by default), masks [B, N] /
    [B, M]; variant "plane" needs `tgt_normals` [B, M, 3] (unit)."""
    if params.variant == "plane" and tgt_normals is None:
        raise ValueError("point-to-plane ICP requires tgt_normals")
    src = src.to(torch.float32)
    tgt = tgt.to(torch.float32)
    batch = src.shape[0]
    if T_init is None:
        T_init = torch.eye(4, dtype=torch.float32, device=src.device).expand(batch, 4, 4)
    T = T_init.to(torch.float32)

    # Iteration i evaluates the transform after i updates; the last one
    # only evaluates, so rmse and num_matched describe the returned T.
    Ts, rmses, matched = [], [], []
    for it in range(params.max_iters + 1):
        x = mm(src, T[:, :3, :3].transpose(-1, -2)) + T[:, None, :3, 3]
        idx, dist = nearest_neighbors(x, tgt, mask_tgt=mask_tgt, block_rows=params.nn_block_rows)
        gidx = idx[..., None].expand(*idx.shape, 3)
        q = torch.gather(tgt, 1, gidx)
        w = _match_weights(dist, mask_src, params)
        wsum = w.sum(-1)
        Ts.append(T)
        rmses.append(torch.sqrt((w * dist * dist).sum(-1) / torch.clamp_min(wsum, 1e-9)))
        matched.append((w > 0).sum(-1, dtype=torch.int32))
        if it == params.max_iters:
            break
        if params.variant == "point":
            # Re-fit from the original source points: each iteration is the
            # global optimum for its correspondence set.
            T_new = transform_from_rt(*umeyama(src, q, w=w))
        else:
            n = torch.gather(tgt_normals, 1, gidx)
            r = (n * (x - q)).sum(-1)
            J = torch.cat([n, torch.linalg.cross(x, n, dim=-1)], dim=-1)       # [B, N, 6]
            A = mm((w[..., None] * J).transpose(-1, -2), J)
            A = A + params.plane_damping * torch.eye(6, dtype=A.dtype, device=A.device)
            b = -mm(J.transpose(-1, -2), (w * r)[..., None])
            xi = torch.linalg.solve_ex(A, b).result[..., 0]     # no host sync on the info
            xi = torch.where(torch.isfinite(xi).all(-1, keepdim=True), xi, 0.0)
            T_new = mm(se3.exp_se3(xi), T)
        T = torch.where((wsum >= 3.0)[:, None, None], T_new, T)
    T_final = Ts[-1]
    return IcpResult(T=T_final, R=T_final[:, :3, :3], t=T_final[:, :3, 3], rmse=rmses[-1],
                     rmse_trace=torch.stack(rmses[1:], dim=-1), num_matched=matched[-1])


def icp(
    src: torch.Tensor,
    tgt: torch.Tensor,
    params: IcpParams,
    T_init: Optional[torch.Tensor] = None,
    mask_src: Optional[torch.Tensor] = None,
    mask_tgt: Optional[torch.Tensor] = None,
    tgt_normals: Optional[torch.Tensor] = None,
) -> IcpResult:
    """Refine one rigid transform: src [N, 3], tgt [M, 3] (a batch of one,
    returned without the batch axis)."""
    add = lambda x: None if x is None else x[None]
    res = icp_batch(src[None], tgt[None], params, T_init=add(T_init), mask_src=add(mask_src),
                    mask_tgt=add(mask_tgt), tgt_normals=add(tgt_normals))
    return IcpResult(*(x[0] for x in res))
