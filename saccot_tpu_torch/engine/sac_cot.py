"""The SAC-COT estimator on PyTorch: batched correspondence-set registration.

Port of `saccot_tpu/engine/sac_cot.py` (`register_batch` and
`register_pair`). Per batch element: compatibility degrees -> triangle pool
-> 3-point solves -> hypothesis scores -> first-maximum argmax ->
`refine_iters` weighted-Umeyama passes on the inlier set. The JAX
package's `vmap` becomes the explicit leading batch axis of every tensor.

`impl="kernel"` routes the four hot stages through the kernel wrappers
(the CUDA kernels for CUDA tensors, their plain versions for CPU tensors),
which pick their kernel by N (no cap); `impl="plain"` runs the plain
PyTorch versions on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from saccot_tpu.utils.params import SacCotParams
from saccot_tpu_torch.engine import score as score_mod
from saccot_tpu_torch.engine import triangles as tri_mod
from saccot_tpu_torch.engine.svd3 import transform_from_rt, umeyama
from saccot_tpu_torch.kernels import compat as compat_k
from saccot_tpu_torch.kernels import score as score_k
from saccot_tpu_torch.kernels import solve3 as solve3_k
from saccot_tpu_torch.kernels.triangles import MAX_NEIGHBORS


class RegistrationResult(NamedTuple):
    R: torch.Tensor            # [batch, 3, 3]
    t: torch.Tensor            # [batch, 3]
    T: torch.Tensor            # [batch, 4, 4]
    inliers: torch.Tensor      # [batch, N] bool
    num_inliers: torch.Tensor  # [batch] int32
    best_score: torch.Tensor   # [batch] float32 (pre-refinement hypothesis score)
    num_valid_triangles: torch.Tensor  # [batch] int32: valid entries in the pool
    success: torch.Tensor      # [batch] bool: at least one valid triangle existed


def _stages(impl: str):
    if impl == "kernel":
        return compat_k.degrees, solve3_k.solve3, score_k.score_hypotheses
    if impl == "plain":
        return (compat_k.degrees_reference, solve3_k.solve3_reference,
                score_k.score_hypotheses_reference)
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


def register_batch(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> RegistrationResult:
    """Register a batch of correspondence sets.

    P, Q: [batch, N, 3] matched source/target points (row n of P matches row
    n of Q); mask: optional [batch, N] validity of each correspondence.
    """
    degrees_fn, solve_fn, score_fn = _stages(impl)
    P = P.to(torch.float32)
    Q = Q.to(torch.float32)
    batch, N, _ = P.shape
    if P.is_cuda and impl == "kernel" and min(params.neighbors_per_anchor, N - 1) > MAX_NEIGHBORS:
        raise NotImplementedError(
            f"neighbors_per_anchor > {MAX_NEIGHBORS}: the anchor kernels hold the "
            "B x B pair grid in shared memory; larger B is listed in ROADMAP queue 3")
    m = (torch.ones((batch, N), dtype=torch.float32, device=P.device)
         if mask is None else mask.to(torch.float32))
    # None masks (not all-ones) let the kernels skip their mask reads.
    kmask = None if mask is None else m

    deg = degrees_fn(P, Q, P, Q, params, mask_rows=kmask, mask_cols=kmask)
    pool = tri_mod.triangle_pool_from_points(P, Q, deg, params, mask=kmask, impl=impl)
    r9, t3 = solve_fn(P, Q, pool.triples)
    scores, _ = score_fn(r9, t3, P, Q, params.inlier_tau, mask=kmask, mode=params.scoring)

    scores = torch.where(pool.valid, scores, -1.0)
    best = torch.argmax(scores, dim=1)                    # first maximum
    best_score = torch.gather(scores, 1, best[:, None])[:, 0]
    Rb = torch.gather(r9, 2, best[:, None, None].expand(batch, 9, 1)).reshape(batch, 3, 3)
    tb = torch.gather(t3, 2, best[:, None, None].expand(batch, 3, 1))[..., 0]

    inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)
    for _ in range(params.refine_iters):
        w = inl.to(torch.float32) * m
        n = w.sum(dim=1)
        Rf, tf = umeyama(P, Q, w=w)
        keep = n >= 3.0  # keep the previous fit when < 3 inliers
        Rb = torch.where(keep[:, None, None], Rf, Rb)
        tb = torch.where(keep[:, None], tf, tb)
        inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)

    success = pool.valid.any(dim=1)
    eye = torch.eye(3, dtype=torch.float32, device=P.device)
    Rb = torch.where(success[:, None, None], Rb, eye)
    tb = torch.where(success[:, None], tb, 0.0)
    inl = inl & success[:, None]
    return RegistrationResult(
        R=Rb,
        t=tb,
        T=transform_from_rt(Rb, tb),
        inliers=inl,
        num_inliers=inl.sum(dim=1, dtype=torch.int32),
        best_score=best_score,
        num_valid_triangles=pool.valid.sum(dim=1, dtype=torch.int32),
        success=success,
    )


def register_pair(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> RegistrationResult:
    """Register one correspondence set P, Q [N, 3] (mask [N]): a batch of one,
    returned without the batch axis."""
    res = register_batch(P[None], Q[None], params,
                         mask=None if mask is None else mask[None], impl=impl)
    return RegistrationResult(*(x[0] for x in res))
