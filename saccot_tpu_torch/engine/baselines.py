"""Baseline sample-consensus estimators for the sampler ablation.

Port of `saccot_tpu/engine/baselines.py`, batched over a leading pair axis
`[batch, N, 3]` (the JAX package `vmap`s the one-pair functions). The
samplers share the estimator's solve, scoring and refine, so an ablation
swaps the sampler only:

- RANSAC: K uniform random correspondence triples (distinct within a
  triple), all solved and scored at once;
- edge-guided: the top-K compatibility edges, each completed with one
  uniform random third correspondence; it uses the graph but not the
  triangle rank.

The randomness is a priority field `u [batch, K, N]` of iid uniforms: the
triples are its top 3 (RANSAC) or the first maximum of each row with the
edge's own two members masked out (edge-guided). Each pair draws its field
from a `torch.Generator` on the problem's device, seeded with the pair's
seed; a caller may pass `u` instead (the CPU tests pass the JAX package's
draws). Every selection breaks ties to the lowest index (stable sorts,
first-maximum argmax), `lax.top_k`'s order.

`impl="kernel"` takes the estimator's kernel wrappers for the degrees
(row 1), the 3-point solve (row 3) and the scores (row 4): the CUDA kernels
on CUDA tensors, their plain versions on CPU tensors; `impl="plain"` takes
the plain versions on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from saccot_tpu_torch.engine import compat as compat_mod
from saccot_tpu_torch.engine import score as score_mod
from saccot_tpu_torch.engine.sac_cot import _stages, register_pair
from saccot_tpu_torch.engine.svd3 import transform_from_rt, umeyama
from saccot_tpu_torch.kernels.triangles import topk_stable
from saccot_tpu_torch.utils.params import SacCotParams

Seeds = Union[int, Sequence[int], torch.Tensor]


class BaselineResult(NamedTuple):
    R: torch.Tensor            # [batch, 3, 3]
    t: torch.Tensor            # [batch, 3]
    T: torch.Tensor            # [batch, 4, 4]
    inliers: torch.Tensor      # [batch, N] bool
    num_inliers: torch.Tensor  # [batch] int32
    best_score: torch.Tensor   # [batch] float32


def _score_refine(r9, t3, P, Q, m, kmask, params: SacCotParams, valid, score_fn):
    """Shared tail: score the K hypotheses (SoA r9 [batch, 9, K], t3
    [batch, 3, K]), mask invalid ones to -1, take the first maximum, then
    `refine_iters` weighted-Umeyama passes on its inliers (a pass with
    fewer than 3 inliers keeps the previous fit)."""
    batch = P.shape[0]
    scores, _ = score_fn(r9, t3, P, Q, params.inlier_tau, mask=kmask, mode=params.scoring)
    scores = torch.where(valid, scores, -1.0)
    best = torch.argmax(scores, dim=1)                                   # first maximum
    Rb = torch.gather(r9, 2, best[:, None, None].expand(batch, 9, 1)).reshape(batch, 3, 3)
    tb = torch.gather(t3, 2, best[:, None, None].expand(batch, 3, 1))[..., 0]
    inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)
    for _ in range(params.refine_iters):
        w = inl.to(torch.float32) * m
        Rf, tf = umeyama(P, Q, w=w)
        keep = w.sum(dim=1) >= 3.0
        Rb = torch.where(keep[:, None, None], Rf, Rb)
        tb = torch.where(keep[:, None], tf, tb)
        inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)
    return BaselineResult(
        R=Rb, t=tb, T=transform_from_rt(Rb, tb), inliers=inl,
        num_inliers=inl.sum(dim=1, dtype=torch.int32),
        best_score=torch.gather(scores, 1, best[:, None])[:, 0],
    )


def _seed_list(seeds: Seeds, batch: int):
    if isinstance(seeds, int):
        return [seeds] * batch
    seeds = [int(s) for s in seeds]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for a batch of {batch}")
    return seeds


def priority_field(seeds: Seeds, batch: int, K: int, N: int, device) -> torch.Tensor:
    """u [batch, K, N]: iid uniforms on [0, 1), pair b drawn from a
    `torch.Generator` on `device` seeded with its seed."""
    out = torch.empty((batch, K, N), dtype=torch.float32, device=device)
    for b, s in enumerate(_seed_list(seeds, batch)):
        g = torch.Generator(device=device)
        g.manual_seed(s)
        out[b] = torch.rand((K, N), generator=g, device=device)
    return out


def _random_triples(u: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[batch, K, 3] index triples, distinct within each triple: the top 3
    of each row of the priority field u [batch, K, N] (masked columns at
    -inf), ties to the lowest index. Uniform over ordered distinct triples."""
    if mask is not None:
        u = torch.where(mask.bool()[:, None, :], u, -torch.inf)
    return topk_stable(u, 3)[1]


def _edge_triples(P, Q, m, kmask, params: SacCotParams, u, degrees_fn):
    """(triples [batch, K, 3], valid [batch, K]) of the edge-guided sampler:
    the anchors are the top-A degrees, their rows of the score matrix go to
    `_complete_edges`."""
    batch, N, _ = P.shape
    A = min(params.num_anchors, N)
    deg = degrees_fn(P, Q, P, Q, params, mask_rows=kmask, mask_cols=kmask)
    anchors = topk_stable(deg, A)[1]                                     # [batch, A]
    gidx = anchors[..., None].expand(batch, A, 3)
    rows = compat_mod.score_block(
        torch.gather(P, 1, gidx), torch.gather(Q, 1, gidx), P, Q, params,
        row_ids=anchors, mask_rows=torch.gather(m, 1, anchors), mask_cols=m,
    )                                                                    # [batch, A, N]
    return _complete_edges(anchors, rows, m, u, params.max_hypotheses)


def _complete_edges(anchors, rows, m, u, K: int):
    """The top-K entries of the anchor rows [batch, A, N] of the score
    matrix, each edge completed by the first maximum of its priority row
    with the edge's members and masked columns at -inf: (triples
    [batch, K, 3], valid [batch, K] where the edge's score is > 0)."""
    N = rows.shape[2]
    # Ties to the lowest flat index: S[i, j] == S[j, i] when both are anchors.
    flat_s, flat_i = topk_stable(rows.reshape(rows.shape[0], -1), K)
    ei = torch.gather(anchors, 1, flat_i // N)
    ej = flat_i % N
    u = torch.where(m.bool()[:, None, :], u, -torch.inf)
    cols = torch.arange(N, device=rows.device)
    u = torch.where((cols == ei[..., None]) | (cols == ej[..., None]), -torch.inf, u)
    ek = torch.argmax(u, dim=2)                                          # first maximum
    return torch.stack([ei, ej, ek], dim=-1), flat_s > 0


def _prepare(P, Q, mask):
    P = P.to(torch.float32)
    Q = Q.to(torch.float32)
    batch, N, _ = P.shape
    m = (torch.ones((batch, N), dtype=torch.float32, device=P.device) if mask is None
         else mask.to(torch.float32))
    return P, Q, m, None if mask is None else m


def ransac_register_batch(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    seeds: Seeds = 0,
    u: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> BaselineResult:
    """Classic 3-point RANSAC at a budget of params.max_hypotheses triples
    a pair. P, Q [batch, N, 3]; mask [batch, N]; seeds: one per pair (an int
    for all); u: the priority field [batch, K, N] in place of the draws."""
    _, solve_fn, score_fn = _stages(impl)
    P, Q, m, kmask = _prepare(P, Q, mask)
    batch, N, _ = P.shape
    K = params.max_hypotheses
    if u is None:
        u = priority_field(seeds, batch, K, N, P.device)
    triples = _random_triples(u, mask=m)
    r9, t3 = solve_fn(P, Q, triples)
    valid = torch.ones((batch, K), dtype=torch.bool, device=P.device)
    return _score_refine(r9, t3, P, Q, m, kmask, params, valid, score_fn)


def edge_guided_register_batch(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    seeds: Seeds = 0,
    u: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> BaselineResult:
    """Two-point compatibility-edge-guided sampling (the paper's middle
    ablation); arguments as `ransac_register_batch`."""
    degrees_fn, solve_fn, score_fn = _stages(impl)
    P, Q, m, kmask = _prepare(P, Q, mask)
    batch, N, _ = P.shape
    if u is None:
        u = priority_field(seeds, batch, params.max_hypotheses, N, P.device)
    triples, valid = _edge_triples(P, Q, m, kmask, params, u, degrees_fn)
    r9, t3 = solve_fn(P, Q, triples)
    return _score_refine(r9, t3, P, Q, m, kmask, params, valid, score_fn)


def _one(fn, P, Q, params, mask, seed, u, impl) -> BaselineResult:
    res = fn(P[None], Q[None], params, mask=None if mask is None else mask[None],
             seeds=[seed], u=None if u is None else u[None], impl=impl)
    return BaselineResult(*(x[0] for x in res))


def ransac_register_pair(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    seed: int = 0,
    u: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> BaselineResult:
    """Classic 3-point RANSAC on one pair P, Q [N, 3] (u [K, N])."""
    return _one(ransac_register_batch, P, Q, params, mask, seed, u, impl)


def edge_guided_register_pair(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    seed: int = 0,
    u: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> BaselineResult:
    """Edge-guided sampling on one pair P, Q [N, 3] (u [K, N])."""
    return _one(edge_guided_register_batch, P, Q, params, mask, seed, u, impl)


def sampler_ablation(
    P: torch.Tensor,
    Q: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    seed: int = 0,
    impl: str = "kernel",
):
    """All three samplers (random / edge-guided / SAC-COT) at one budget on
    one pair: {"ransac": ..., "edge": ..., "saccot": ...}, each with `.T`
    and `.num_inliers`."""
    return {
        "ransac": ransac_register_pair(P, Q, params, mask=mask, seed=seed, impl=impl),
        "edge": edge_guided_register_pair(P, Q, params, mask=mask, seed=seed, impl=impl),
        "saccot": register_pair(P, Q, params, mask=mask, impl=impl),
    }
