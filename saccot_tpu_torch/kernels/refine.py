"""The refine: CUDA kernel wrapper and its plain PyTorch version.

After the best hypothesis, `params.refine_iters` weighted-Umeyama fits on
the inlier set of (R, t), each followed by its inlier pass; a pair with
fewer than 3 inliers keeps its previous fit. `refine_reference` does it in
PyTorch (`engine/score.inlier_mask`, `engine/svd3.umeyama`); `refine` runs
`csrc/refine.cu` on CUDA tensors: two passes a fit (the inlier test and
the first moments, then the test again and the centred cross-covariance,
whose last block per pair runs Horn's iteration and the keep rule) and one
pass for the last inlier mask, 2 refine_iters + 1 launches and no other
device operation. Sums run over segments of SEGMENT points in an order
fixed by N alone, so a pair has the same bits alone as in any batch.
R and t differ from the plain version's by summation order only.

Under SP (`corr_group`) each rank holds a shard of the points: the shard's
sums and cross-covariance are all-reduced between the passes, and the fit
runs in a launch of its own after the second, by the same device function.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from saccot_tpu_torch.dist.collectives import all_reduce
from saccot_tpu_torch.engine import score as score_mod
from saccot_tpu_torch.engine.svd3 import umeyama
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import (
    f32_points, f32_tensor, ptr, stream_of, tickets,
)
from saccot_tpu_torch.utils import debug
from saccot_tpu_torch.utils.params import SacCotParams

# A block of the passes holds one segment, a point a thread (csrc/refine.cu
# kThreads); a pair's blocks lie along the grid's y axis, at most MAX_BATCH.
SEGMENT = 256
MAX_BATCH = 65535
SUMS = 7       # Σw, Σw p, Σw q of a pair
COV = 9        # its cross-covariance H
MOMENTS_PASS, COV_PASS, MASK_PASS = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RefinePlan:
    """Grid of the refine's passes: (segments, batch) blocks of SEGMENT
    threads; `launches`: those of a refine of `iters` fits, with the fit in
    a launch of its own where the points are sharded."""
    batch: int
    segments: int
    iters: int
    sharded: bool

    @property
    def launches(self) -> int:
        return (3 if self.sharded else 2) * self.iters + 1


def refine_plan(batch: int, N: int, iters: int, sharded: bool = False) -> RefinePlan:
    """The grid of a refine of `iters` fits over `batch` pairs of N points
    (N >= 1)."""
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"the refine kernel takes 1 to {MAX_BATCH} pairs a launch, got {batch}")
    if N < 1 or iters < 0:
        raise ValueError(f"no refine of {iters} fits over N={N} points")
    return RefinePlan(batch=batch, segments=-(-N // SEGMENT), iters=iters, sharded=sharded)


def refine_reference(
    P: torch.Tensor,
    Q: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    params: SacCotParams,
    m: torch.Tensor,
    corr_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: `params.refine_iters` weighted-Umeyama fits on the
    inlier set of (R, t), each followed by its inlier pass; a pair with
    fewer than 3 inliers keeps its previous fit. m [batch, N]: the
    correspondence mask (ones where there is none). Returns R, t and the
    inlier mask [batch, N]."""
    inl = score_mod.inlier_mask(R, t, P, Q, params.inlier_tau, mask=m)
    for _ in range(params.refine_iters):
        w = inl.to(torch.float32) * m
        n = all_reduce(w.sum(dim=1), corr_group)
        Rf, tf = umeyama(P, Q, w=w, group=corr_group)
        keep = n >= 3.0  # keep the previous fit when < 3 inliers
        R = torch.where(keep[:, None, None], Rf, R)
        t = torch.where(keep[:, None], tf, t)
        inl = score_mod.inlier_mask(R, t, P, Q, params.inlier_tau, mask=m)
    return R, t, inl


def refine(
    P: torch.Tensor,
    Q: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    params: SacCotParams,
    m: torch.Tensor,
    corr_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The refine of `refine_reference` by `csrc/refine.cu` (its plain
    version on CPU tensors): P, Q [batch, N, 3], R [batch, 3, 3], t
    [batch, 3], m [batch, N] float32. Returns R, t and the inlier mask
    [batch, N] bool."""
    if not P.is_cuda:
        return refine_reference(P, Q, R, t, params, m, corr_group)
    return _refine(P, Q, R, t, params, m, corr_group)


def _check_shapes(P, Q, R, t, m) -> Tuple[int, int]:
    """(batch, N) of the refine's inputs, or raise ValueError."""
    if P.ndim != 3 or P.shape[2] != 3:
        raise ValueError(f"P must be [batch, N, 3], got {tuple(P.shape)}")
    batch, N, _ = P.shape
    for name, x, shape in (("Q", Q, (batch, N, 3)), ("R", R, (batch, 3, 3)),
                           ("t", t, (batch, 3)), ("m", m, (batch, N))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    return batch, N


def _refine(P, Q, R, t, params: SacCotParams, m, corr_group=None):
    """Launch the refine's passes; shapes and the plan are checked before
    the devices, so CPU tensors of a wrong shape raise here too."""
    batch, N = _check_shapes(P, Q, R, t, m)
    plan = (refine_plan(batch, N, params.refine_iters, sharded=corr_group is not None)
            if batch and N else None)
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    R = f32_tensor(R, (batch, 3, 3), "R")
    t = f32_tensor(t, (batch, 3), "t")
    m = f32_tensor(m, (batch, N), "m")
    dev = P.device
    inl = torch.empty((batch, N), dtype=torch.bool, device=dev)
    if plan is None:
        return R, t, inl
    stream = stream_of(P)
    tau = float(np.float32(params.inlier_tau))
    Rs = torch.empty((plan.iters, batch, 3, 3), dtype=torch.float32, device=dev)
    ts = torch.empty((plan.iters, batch, 3), dtype=torch.float32, device=dev)
    sums = torch.empty((batch, SUMS), dtype=torch.float32, device=dev)
    cov = torch.empty((batch, COV), dtype=torch.float32, device=dev) if plan.sharded else None
    part = ticket_buf = None
    if plan.segments > 1:
        part = torch.empty((batch, plan.segments, COV), dtype=torch.float32, device=dev)
        ticket_buf = tickets(dev, stream, batch)
    lib = _build.library()

    def run(pass_, R_in, t_in, sums_, R_out, t_out, outputs):
        fit = pass_ == COV_PASS and not plan.sharded
        rc = lib.saccot_refine_pass(
            pass_, int(fit), ptr(P), ptr(Q), ptr(m), ptr(R_in), ptr(t_in), ptr(sums_),
            ptr(cov), ptr(R_out), ptr(t_out), ptr(inl), ptr(part), ptr(ticket_buf),
            batch, N, plan.segments, tau, stream)
        _launched(rc, "refine", *outputs)

    for i in range(plan.iters):
        run(MOMENTS_PASS, R, t, sums, None, None, (sums,))
        sums_all = all_reduce(sums, corr_group)
        run(COV_PASS, R, t, sums_all, Rs[i], ts[i], (cov,) if plan.sharded else (Rs[i], ts[i]))
        if plan.sharded:
            cov_all = all_reduce(cov, corr_group)
            rc = lib.saccot_refine_fit(ptr(sums_all), ptr(cov_all), ptr(R), ptr(t), ptr(Rs[i]),
                                       ptr(ts[i]), batch, stream)
            _launched(rc, "refine_fit", Rs[i], ts[i])
        R, t = Rs[i], ts[i]
    run(MASK_PASS, R, t, None, None, None, (inl,))
    return R, t, inl


def _launched(rc: int, name: str, *outputs: torch.Tensor) -> None:
    """Check and count a launch of `csrc/refine.cu`."""
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    debug.check_kernel(name, *outputs)
