"""Compatibility-triangle (COT) pool: ranking and selection — PyTorch.

Port of the N <= 4096 path of `saccot_tpu/engine/triangles.py`
(`triangle_pool_from_points` with the fused anchor kernel):

  1. anchors: the `num_anchors` nodes of highest weighted degree;
  2. per anchor, its `neighbors_per_anchor` strongest edges and the candidate
     triangles among them (kernels/triangles.anchor_neighbors);
  3. fast config (`per_anchor_candidates = T > 0`): each anchor's top-T
     candidates, then a global top-K over the A*T of them (the identity when
     A*T <= K);
     exact config: cross-anchor duplicates invalidated, canonical (lo, mid,
     hi) triples, then an exact global top-K.

Every top-k here is a stable descending sort, `lax.top_k`'s order. Where the
JAX package asks for `approx_max_k` (approx_topk=True with A*T > K) the port
takes the exact top-K. Node ids are int64 throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from saccot_tpu.utils.params import SacCotParams
from saccot_tpu_torch.kernels import triangles as tri_kernels
from saccot_tpu_torch.kernels.triangles import topk_stable


class TrianglePool(NamedTuple):
    # [batch, K, 3] int64 node triples: canonical lo < mid < hi with dedup,
    # (anchor, nbr, nbr) without. Padded entries are (0, 0, 0).
    triples: torch.Tensor
    scores: torch.Tensor   # [batch, K] float32, -1 for padded/invalid entries
    valid: torch.Tensor    # [batch, K] bool


def triangle_pool_from_points(
    P: torch.Tensor,
    Q: torch.Tensor,
    deg: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> TrianglePool:
    """Degrees and points [batch, N, 3] in, ranked triangles out.

    impl="kernel" goes through `kernels.triangles.anchor_neighbors` (the CUDA
    kernel on a card, its plain version on the CPU); impl="plain" calls the
    plain version on any device.
    """
    batch, N, _ = P.shape
    A = min(params.num_anchors, N)
    B = min(params.neighbors_per_anchor, N - 1)
    _, anchors = topk_stable(deg, A)                               # [batch, A]
    anchor_mask = None if mask is None else torch.gather(mask, 1, anchors)
    fn = (tri_kernels.anchor_neighbors if impl == "kernel"
          else tri_kernels.anchor_neighbors_reference)
    if params.per_anchor_candidates > 0:
        T = min(params.per_anchor_candidates, B * (B - 1) // 2)
        _, _, cand_s, cand_j, cand_k = fn(
            P, Q, anchors, B, params.compat_tau, params.min_separation,
            mask=mask, anchor_mask=anchor_mask, top_t=T)
        return _pool_from_preranked(anchors, cand_s, cand_j, cand_k, params)
    nbr_s, nbr_idx, cand = fn(
        P, Q, anchors, B, params.compat_tau, params.min_separation,
        mask=mask, anchor_mask=anchor_mask, emit_candidates=True)
    b1, b2 = (torch.as_tensor(x, device=P.device) for x in np.triu_indices(B, k=1))
    i = anchors[:, :, None].expand(batch, A, b1.shape[0])
    j = nbr_idx[:, :, b1]
    k = nbr_idx[:, :, b2]
    dedup_done = False
    if params.dedup_triangles:
        dup = _mark_cross_anchor_duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2, N)
        cand = torch.where(dup, -1.0, cand)
        dedup_done = True
    return _rank_candidates(i, j, k, cand, params, dedup_done=dedup_done)


def _mark_cross_anchor_duplicates(
    anchors: torch.Tensor,    # [batch, A] anchor node ids (distinct)
    nbr_idx: torch.Tensor,    # [batch, A, B] neighbour node ids per anchor
    nbr_valid: torch.Tensor,  # [batch, A, B] bool: selection has positive score
    b1: torch.Tensor,         # [Pairs] upper-triangle template
    b2: torch.Tensor,
    n_nodes: int,
) -> torch.Tensor:
    """Exact dedup mask [batch, A, Pairs].

    A triangle enters the candidate list once per vertex that is an anchor
    holding the other two among its valid top-B neighbours; the copy at the
    smallest anchor slot is kept. A candidate (a, b1, b2) is a duplicate iff
    one of its neighbour vertices is an anchor x at a smaller slot whose
    valid row holds both anchors[a] and the other neighbour. The JAX version
    finds slot(a, b) with one-hot contractions (no TPU gathers); here an
    inverse node -> anchor-slot map is gathered directly.
    """
    batch, A, B = nbr_idx.shape
    slot_of = torch.full((batch, n_nodes), -1, dtype=torch.int64, device=anchors.device)
    slot_of.scatter_(1, anchors, torch.arange(A, device=anchors.device).expand(batch, A))
    x = torch.gather(slot_of, 1, nbr_idx.reshape(batch, A * B)).reshape(batch, A, B)
    match = (x >= 0) & nbr_valid                       # neighbour (a, b) is anchor slot x
    rows = x.clamp_min(0).reshape(batch, A * B, 1).expand(batch, A * B, B)
    R3 = torch.gather(nbr_idx, 1, rows).reshape(batch, A, B, B)    # row of slot x
    V3 = torch.gather(nbr_valid, 1, rows).reshape(batch, A, B, B) & match[..., None]
    # anchors[a] is a valid neighbour of x, and x comes first.
    holds_a = ((R3 == anchors[:, :, None, None]) & V3).any(dim=-1)
    earlier = x < torch.arange(A, device=x.device)[None, :, None]
    gate = match & earlier & holds_a                                # [batch, A, B]
    # in_row[a, b, t]: nbr_idx[a, t] is a valid neighbour of slot(a, b)'s anchor.
    in_row = ((R3[..., :, None] == nbr_idx[:, :, None, None, :])
              & V3[..., :, None]).any(dim=-2)                       # [batch, A, B, T]
    return ((gate[:, :, b1] & in_row[:, :, b1, b2])
            | (gate[:, :, b2] & in_row[:, :, b2, b1]))


def _rank_candidates(
    i: torch.Tensor,       # [batch, A, Pairs] anchor node ids
    j: torch.Tensor,       # [batch, A, Pairs] neighbour-1 node ids
    k: torch.Tensor,       # [batch, A, Pairs] neighbour-2 node ids
    score: torch.Tensor,   # [batch, A, Pairs] candidate scores, -1 = invalid
    params: SacCotParams,
    dedup_done: bool = False,
) -> TrianglePool:
    """(optional canonicalisation) -> global top-K of a candidate set."""
    batch = score.shape[0]
    score = score.reshape(batch, -1)
    fi, fj, fk = (x.reshape(batch, -1) for x in (i, j, k))
    if not params.dedup_triangles:
        # Solve and scoring are permutation-invariant: keep (anchor, j, k).
        return _select_topk((fi, fj, fk), score, params)
    if not dedup_done:
        raise ValueError(
            "dedup_triangles=True requires the caller to invalidate cross-"
            "anchor duplicates (_mark_cross_anchor_duplicates) and pass "
            "dedup_done=True")
    a0 = torch.minimum(fi, fj)
    b0 = torch.maximum(fi, fj)
    lo2 = torch.minimum(b0, fk)
    hi = torch.maximum(b0, fk)
    lo = torch.minimum(a0, lo2)
    mid = torch.maximum(a0, lo2)
    return _select_topk((lo, mid, hi), score, params)


def _pool_from_preranked(
    anchors: torch.Tensor,   # [batch, A] anchor node ids
    cand_s: torch.Tensor,    # [batch, A, T] per-anchor top-T candidate scores
    cand_j: torch.Tensor,    # [batch, A, T] node id of neighbour b1
    cand_k: torch.Tensor,    # [batch, A, T] node id of neighbour b2
    params: SacCotParams,
) -> TrianglePool:
    """Global top-K over per-anchor preranked candidates; with A*T <= K every
    candidate enters and the selection is the identity."""
    batch, A, T = cand_s.shape
    flat_s = cand_s.reshape(batch, A * T)
    i = anchors.repeat_interleave(T, dim=1)
    j = cand_j.reshape(batch, A * T)
    k = cand_k.reshape(batch, A * T)
    if params.max_hypotheses >= A * T:
        return _pool_from_selected((i, j, k), flat_s, params)
    return _select_topk((i, j, k), flat_s, params)


def _pool_from_selected(tri_cols, top_s: torch.Tensor, params: SacCotParams) -> TrianglePool:
    K = params.max_hypotheses
    triples = torch.stack(tri_cols, dim=-1).to(torch.int64)
    pad = K - top_s.shape[1]
    if pad > 0:  # pad to the static budget
        triples = torch.cat([triples, triples.new_zeros((triples.shape[0], pad, 3))], dim=1)
        top_s = torch.cat([top_s, top_s.new_full((top_s.shape[0], pad), -1.0)], dim=1)
    return TrianglePool(triples=triples, scores=top_s, valid=top_s > 0)


def _select_topk(tri_cols, ss: torch.Tensor, params: SacCotParams) -> TrianglePool:
    top_s, top_i = topk_stable(ss, min(params.max_hypotheses, ss.shape[1]))
    return _pool_from_selected([torch.gather(c, 1, top_i) for c in tri_cols], top_s, params)
