"""The SAC-COT estimator on PyTorch: batched correspondence-set registration.

Port of `saccot_tpu/engine/sac_cot.py`. Per batch element: compatibility
degrees -> triangle pool -> 3-point solves -> hypothesis scores ->
first-maximum argmax -> `refine_iters` weighted-Umeyama passes on the
inlier set. The JAX
package's `vmap` becomes the explicit leading batch axis of every tensor.

`impl="kernel"` routes the four hot stages and the refine through the
kernel wrappers (the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors), which pick their kernel by N (no cap); `impl="plain"`
runs the plain PyTorch versions on any device. `compat_impl`, `pool_impl`,
`solve_impl` and `score_impl` set one stage's route each ("kernel" or
"plain", `impl` where one is not given; the refine follows `impl`), as the
JAX package's four selectors do: the stages hand each other tensors on the
device they run on, so one stage can run by its plain version and the rest
by their kernels. A kernel stage on a CUDA tensor launches its kernel or
raises; it never falls back.

The sharded bodies (`_register_pair`'s `corr_axis` / `hyp_axis` branches
in the JAX package) run over `torch.distributed` groups:
- SP, `register_batch_sp`: each rank of `corr_group` holds [batch, n_loc]
  correspondences; one all-gather of the points feeds the replicated pool
  stage, while degree rows, scoring and the refine stay sharded with summed
  counts and moments. The degree rows take the ring (`params.ring_compat`)
  or the direct-form kernel against the gathered columns (`mxu=False`:
  the rows are a slice, so the explicit i != j test on `row_offset + i` is
  the one that matters);
- TP, `register_batch_tp` (and `hyp_group` under SP): each rank solves and
  scores K/d of the replicated pool; the champions are gathered in rank
  order, so the first-maximum tie-break of one rank holds.

`register_pair_sp` and `register_pair_tp` are the per-pair forms of the
JAX package's sharded bodies: a batch of one, returned without the axis.

Every call runs its stages in seven consecutive `torch.profiler` ranges
named `STAGE_PREFIX + <stage>`: degrees (the casts, the mask and the
degree rows, with SP's gathers or ring), pool (the triangle pool and TP's
slice of it), solve, score, select (the best hypothesis and TP's champion
gather), refine and result (the success masks, T and the counts). A
profile of any call reads each stage's host and device time
(`utils.profile.profile_call(..., ranges=STAGE_PREFIX)`).

A masked call also records its valid correspondences per pair,
`mask.sum(1)` as an int64 device tensor, in `VALID_COUNTS`: the last
`VALID_COUNTS_KEPT` masked calls, most recent last. A masked kernel computes
its padded rows too, so a roofline of the work a deployment needs reads
these counts, not the padded N. Recording launches one reduction and never
waits for the card; an unmasked call records nothing. On the symmetric
degree route (N > 2,048, a card) the kernel skips the tile pairs its mask
leaves empty and keeps their count per pair in
`kernels/compat.TILE_PAIRS_SKIPPED`.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from saccot_tpu_torch.dist.collectives import all_gather, all_reduce, group_rank, group_size
from saccot_tpu_torch.dist.ring import degrees_ring
from saccot_tpu_torch.engine import triangles as tri_mod
from saccot_tpu_torch.engine.svd3 import transform_from_rt
from saccot_tpu_torch.kernels import compat as compat_k
from saccot_tpu_torch.kernels import refine as refine_k
from saccot_tpu_torch.kernels import score as score_k
from saccot_tpu_torch.kernels import solve3 as solve3_k
from saccot_tpu_torch.kernels.triangles import MAX_NEIGHBORS
from saccot_tpu_torch.utils.params import SacCotParams

# The profiler ranges of `_register_batch`'s stages are named STAGE_PREFIX + <stage>.
STAGE_PREFIX = "saccot/"


def _stage(name: str):
    return record_function(STAGE_PREFIX + name)


class ValidCounts(NamedTuple):
    """One masked call's record in `VALID_COUNTS`."""
    n_valid: torch.Tensor  # [batch] int64 on the call's device: mask.sum(1)
    local: bool            # SP: the counts of this rank's shard of the points only


VALID_COUNTS_KEPT = 64
VALID_COUNTS: Deque[ValidCounts] = deque(maxlen=VALID_COUNTS_KEPT)


def _record_valid_counts(mask: torch.Tensor, local: bool) -> None:
    """Keep a masked call's valid correspondences per pair in `VALID_COUNTS`,
    on the device: no host sync, no read on the host."""
    VALID_COUNTS.append(ValidCounts(mask.sum(dim=1, dtype=torch.int64), local))


class RegistrationResult(NamedTuple):
    R: torch.Tensor            # [batch, 3, 3]
    t: torch.Tensor            # [batch, 3]
    T: torch.Tensor            # [batch, 4, 4]
    inliers: torch.Tensor      # [batch, N] bool (the local shard under SP)
    num_inliers: torch.Tensor  # [batch] int32 (global under SP)
    best_score: torch.Tensor   # [batch] float32 (pre-refinement hypothesis score)
    num_valid_triangles: torch.Tensor  # [batch] int32: valid entries in the pool
    success: torch.Tensor      # [batch] bool: at least one valid triangle existed


def _routes(impl: str, compat_impl: Optional[str] = None, pool_impl: Optional[str] = None,
            solve_impl: Optional[str] = None, score_impl: Optional[str] = None) -> dict:
    """Each stage's route, "kernel" or "plain": its own argument, else `impl`."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    routes = {}
    for stage, route in (("compat", compat_impl), ("pool", pool_impl), ("solve", solve_impl),
                         ("score", score_impl)):
        route = impl if route is None else route
        if route not in ("kernel", "plain"):
            raise ValueError(f"{stage}_impl must be 'kernel' or 'plain', got {route!r}")
        routes[stage] = route
    return routes


def _stages(routes: dict):
    """The degree, solve and score functions, each by its route (`_routes`)."""
    kernel = {stage: route == "kernel" for stage, route in routes.items()}
    return (compat_k.degrees if kernel["compat"] else compat_k.degrees_reference,
            solve3_k.solve3 if kernel["solve"] else solve3_k.solve3_reference,
            score_k.score_hypotheses if kernel["score"] else score_k.score_hypotheses_reference)


def best_hypothesis(
    scores: torch.Tensor, valid: torch.Tensor, r9: torch.Tensor, t3: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first maximum of each pair's valid hypotheses (scores, valid
    [batch, K]; r9 [batch, 9, K], t3 [batch, 3, K]): its score [batch],
    R [batch, 3, 3] and t [batch, 3]."""
    batch = scores.shape[0]
    scores = torch.where(valid, scores, -1.0)
    best = torch.argmax(scores, dim=1)                    # first maximum
    best_score = torch.gather(scores, 1, best[:, None])[:, 0]
    Rb = torch.gather(r9, 2, best[:, None, None].expand(batch, 9, 1)).reshape(batch, 3, 3)
    tb = torch.gather(t3, 2, best[:, None, None].expand(batch, 3, 1))[..., 0]
    return best_score, Rb, tb


def refine(
    P: torch.Tensor,
    Q: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    params: SacCotParams,
    m: torch.Tensor,
    corr_group=None,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`params.refine_iters` weighted-Umeyama fits on the inlier set of
    (R, t), each followed by its inlier pass; a pair with fewer than 3
    inliers keeps its previous fit. m [batch, N]: the correspondence mask
    (ones where there is none). Returns R, t and the inlier mask [batch, N].
    impl "kernel": `kernels/refine.refine` (`csrc/refine.cu` on CUDA
    tensors, the plain version on CPU ones); "plain": the plain version."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    fn = refine_k.refine if impl == "kernel" else refine_k.refine_reference
    return fn(P, Q, R, t, params, m, corr_group)


def _register_batch(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor],
    impl: str,
    corr_group=None,
    hyp_group=None,
    compat_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
) -> RegistrationResult:
    """The estimator body. `corr_group`: P, Q, mask are this rank's shard of
    the correspondence axis (SP); `hyp_group`: the pool is sliced over it
    (TP). With neither, no collective runs. The `*_impl` routes default to
    `impl`."""
    routes = _routes(impl, compat_impl, pool_impl, solve_impl, score_impl)
    degrees_fn, solve_fn, score_fn = _stages(routes)
    with _stage("degrees"):
        P = P.to(torch.float32)
        Q = Q.to(torch.float32)
        batch, n_loc, _ = P.shape
        m = (torch.ones((batch, n_loc), dtype=torch.float32, device=P.device)
             if mask is None else mask.to(torch.float32))
        # None masks (not all-ones) let the kernels skip their mask reads.
        kmask = None if mask is None else m
        if mask is not None:
            _record_valid_counts(mask, local=corr_group is not None)

        if corr_group is None:
            P_full, Q_full, kmask_full = P, Q, kmask
            deg = degrees_fn(P, Q, P, Q, params, mask_rows=kmask, mask_cols=kmask)
        else:
            # One small all-gather of raw points; everything quadratic stays sharded.
            P_full, Q_full = all_gather(P, corr_group, dim=1), all_gather(Q, corr_group, dim=1)
            kmask_full = None if kmask is None else all_gather(kmask, corr_group, dim=1)
            if params.ring_compat:
                deg = degrees_ring(P, Q, params, corr_group, mask_loc=kmask,
                                   impl=routes["compat"])
            else:
                deg = degrees_fn(P, Q, P_full, Q_full, params,
                                 row_offset=group_rank(corr_group) * n_loc,
                                 mask_rows=kmask, mask_cols=kmask_full, mxu=False)
            deg = all_gather(deg, corr_group, dim=1)
    N = P_full.shape[1]
    if (P.is_cuda and routes["pool"] == "kernel"
            and min(params.neighbors_per_anchor, N - 1) > MAX_NEIGHBORS):
        raise NotImplementedError(
            f"neighbors_per_anchor > {MAX_NEIGHBORS}: the anchor kernels hold the "
            "B x B pair grid in shared memory; larger B is listed in ROADMAP queue 3")

    with _stage("pool"):
        pool = tri_mod.triangle_pool_from_points(P_full, Q_full, deg, params, mask=kmask_full,
                                                 impl=routes["pool"], anchor_group=corr_group)
        triples, hyp_valid = pool.triples, pool.valid
        if hyp_group is not None:
            d_h = group_size(hyp_group)
            K = pool.scores.shape[1]
            if K % d_h:
                raise ValueError(
                    f"max_hypotheses={K} must be divisible by the hyp group size {d_h}")
            k0 = group_rank(hyp_group) * (K // d_h)
            triples = triples[:, k0:k0 + K // d_h].contiguous()
            hyp_valid = hyp_valid[:, k0:k0 + K // d_h]
    with _stage("solve"):
        r9, t3 = solve_fn(P_full, Q_full, triples)
    with _stage("score"):
        scores, _ = score_fn(r9, t3, P, Q, params.inlier_tau, mask=kmask, mode=params.scoring,
                             group=corr_group)

    with _stage("select"):
        best_score, Rb, tb = best_hypothesis(scores, hyp_valid, r9, t3)
        if hyp_group is not None:
            # Champions of every slice, gathered in rank order: the argmax over
            # them keeps the first maximum of the whole pool.
            g_scores = all_gather(best_score[None], hyp_group, dim=0)   # [d_h, batch]
            g_R = all_gather(Rb[None], hyp_group, dim=0)
            g_t = all_gather(tb[None], hyp_group, dim=0)
            g_best = torch.argmax(g_scores, dim=0)
            rows = torch.arange(batch, device=P.device)
            best_score, Rb, tb = g_scores[g_best, rows], g_R[g_best, rows], g_t[g_best, rows]

    with _stage("refine"):
        Rb, tb, inl = refine(P, Q, Rb, tb, params, m, corr_group, impl=impl)

    with _stage("result"):
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
            num_inliers=all_reduce(inl.sum(dim=1, dtype=torch.int32), corr_group),
            best_score=best_score,
            num_valid_triangles=pool.valid.sum(dim=1, dtype=torch.int32),
            success=success,
        )


def register_batch(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    compat_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
) -> RegistrationResult:
    """Register a batch of correspondence sets.

    P, Q: [batch, N, 3] matched source/target points (row n of P matches row
    n of Q); mask: optional [batch, N] validity of each correspondence.
    impl: every stage's route, "kernel" or "plain"; compat_impl, score_impl,
    pool_impl, solve_impl: one stage's route each, `impl` where None.
    """
    return _register_batch(P, Q, params, mask, impl, compat_impl=compat_impl,
                           pool_impl=pool_impl, solve_impl=solve_impl, score_impl=score_impl)


def _one_pair(register, P, Q, mask, *args, **kw) -> RegistrationResult:
    """`register(P[None], Q[None], *args, mask[None], **kw)`: a batch of one
    (the mask follows `args`), returned without the batch axis."""
    res = register(P[None], Q[None], *args, None if mask is None else mask[None], **kw)
    return RegistrationResult(*(x[0] for x in res))


def register_pair(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    compat_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
) -> RegistrationResult:
    """Register one correspondence set P, Q [N, 3] (mask [N]): a batch of one,
    returned without the batch axis."""
    return _one_pair(register_batch, P, Q, mask, params, impl=impl, compat_impl=compat_impl,
                     score_impl=score_impl, pool_impl=pool_impl, solve_impl=solve_impl)


def register_batch_sp(
    P_loc: torch.Tensor,
    Q_loc: torch.Tensor,
    params: SacCotParams,
    corr_group,
    mask_loc: Optional[torch.Tensor] = None,
    hyp_group=None,
    impl: str = "kernel",
    compat_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
) -> RegistrationResult:
    """Correspondence-sharded (SP) estimator, called on every rank of
    `corr_group` with its [batch, n_loc, 3] shard (rank r holds global
    correspondences r * n_loc ... (r + 1) * n_loc - 1).

    `inliers` is the local shard; every other field is global and the same
    on every rank. `hyp_group` also shards the hypothesis pool (TP). The
    routes are `register_batch`'s.
    """
    return _register_batch(P_loc, Q_loc, params, mask_loc, impl, corr_group=corr_group,
                           hyp_group=hyp_group, compat_impl=compat_impl, pool_impl=pool_impl,
                           solve_impl=solve_impl, score_impl=score_impl)


def register_batch_tp(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    hyp_group,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    compat_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
) -> RegistrationResult:
    """Hypothesis-sharded (TP) estimator: every rank of `hyp_group` holds
    the whole batch, solves and scores its K/d slice of the pool, and the
    best hypothesis is reduced over the group. Every field is replicated.
    The routes are `register_batch`'s.
    """
    return _register_batch(P, Q, params, mask, impl, hyp_group=hyp_group,
                           compat_impl=compat_impl, pool_impl=pool_impl, solve_impl=solve_impl,
                           score_impl=score_impl)


def register_pair_sp(
    P_loc: torch.Tensor,
    Q_loc: torch.Tensor,
    params: SacCotParams,
    corr_group,
    mask_loc: Optional[torch.Tensor] = None,
    hyp_group=None,
    impl: str = "kernel",
    compat_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
) -> RegistrationResult:
    """`register_batch_sp` on one pair: this rank's shard P_loc, Q_loc
    [n_loc, 3] (mask_loc [n_loc]), returned without the batch axis."""
    return _one_pair(register_batch_sp, P_loc, Q_loc, mask_loc, params, corr_group,
                     hyp_group=hyp_group, impl=impl, compat_impl=compat_impl,
                     score_impl=score_impl, pool_impl=pool_impl, solve_impl=solve_impl)


def register_pair_tp(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    hyp_group,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    compat_impl: Optional[str] = None,
    score_impl: Optional[str] = None,
    pool_impl: Optional[str] = None,
    solve_impl: Optional[str] = None,
) -> RegistrationResult:
    """`register_batch_tp` on one pair P, Q [N, 3] (mask [N]), returned
    without the batch axis."""
    return _one_pair(register_batch_tp, P, Q, mask, params, hyp_group, impl=impl,
                     compat_impl=compat_impl, score_impl=score_impl, pool_impl=pool_impl,
                     solve_impl=solve_impl)
