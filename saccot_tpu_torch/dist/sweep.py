"""Sharded registration sweep: DP over pairs x TP over hypotheses x SP over
correspondences.

Port of `saccot_tpu/dist/sweep.py`. As there, the sweep takes and returns
global arrays: every rank passes the full [B, N, 3] batch (and mask), runs
the estimator on its (pairs, corr) block — B / pairs pairs, N / corr
correspondences, K / hyp hypotheses of each pool — and gets the full [B, ...]
result back, gathered over "pairs" (and `inliers` over "corr" too). With
corr = hyp = 1 the estimator runs without a collective; only the result is
gathered at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from saccot_tpu_torch.dist.collectives import all_gather
from saccot_tpu_torch.dist.mesh import axis_group, axis_size, local_batch_size
from saccot_tpu_torch.engine.sac_cot import RegistrationResult, register_batch_sp
from saccot_tpu_torch.utils.params import SacCotParams


def make_sweep_fn(mesh, params: SacCotParams, impl: str = "kernel",
                  compat_impl: Optional[str] = None, score_impl: Optional[str] = None,
                  pool_impl: Optional[str] = None, solve_impl: Optional[str] = None):
    """A sweep over `mesh`: (P [B, N, 3], Q [B, N, 3], mask [B, N] or None)
    -> RegistrationResult of [B, ...] fields, the same on every rank. The
    routes are `engine.sac_cot.register_batch`'s."""
    routes = dict(impl=impl, compat_impl=compat_impl, score_impl=score_impl,
                  pool_impl=pool_impl, solve_impl=solve_impl)
    corr_group = axis_group(mesh, "corr")
    hyp_group = axis_group(mesh, "hyp")
    pairs_group = axis_group(mesh, "pairs")
    d_c = axis_size(mesh, "corr")
    p_rank, c_rank = mesh.get_local_rank("pairs"), mesh.get_local_rank("corr")

    def sweep(P_all: torch.Tensor, Q_all: torch.Tensor,
              mask_all: Optional[torch.Tensor] = None) -> RegistrationResult:
        B, N = P_all.shape[:2]
        b_loc = local_batch_size(B, mesh)
        if N % d_c:
            raise ValueError(f"N={N} not divisible by the corr axis size {d_c}")
        n_loc = N // d_c
        rows = slice(p_rank * b_loc, (p_rank + 1) * b_loc)
        cols = slice(c_rank * n_loc, (c_rank + 1) * n_loc)
        # corr_group None (corr = 1): the unsharded body, no collective.
        res = register_batch_sp(
            P_all[rows, cols], Q_all[rows, cols], params, corr_group,
            mask_loc=None if mask_all is None else mask_all[rows, cols],
            hyp_group=hyp_group, **routes,
        )
        res = res._replace(inliers=all_gather(res.inliers, corr_group, dim=1))
        return RegistrationResult(*(all_gather(x, pairs_group, dim=0) for x in res))

    return sweep


def run_sweep(sweep_fn, P_all: torch.Tensor, Q_all: torch.Tensor,
              mask_all: Optional[torch.Tensor] = None) -> RegistrationResult:
    """Drive a sweep on a full batch; a missing mask is all ones, as in the
    JAX package."""
    if mask_all is None:
        mask_all = torch.ones(P_all.shape[:2], dtype=torch.float32, device=P_all.device)
    return sweep_fn(P_all, Q_all, mask_all)
