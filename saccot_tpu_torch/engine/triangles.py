"""Compatibility-triangle (COT) pool: ranking and selection — PyTorch.

Port of `saccot_tpu/engine/triangles.py::triangle_pool_from_points` on its
kernel route (`impl="pallas"`):

  1. anchors: the `num_anchors` nodes of highest weighted degree;
  2. per anchor, its `neighbors_per_anchor` strongest edges and the candidate
     triangles among them. Up to N = MAX_N_FUSED one fused kernel does both
     (kernels/triangles.anchor_neighbors); above it the neighbours are
     streamed (anchor_neighbors_stream) and the candidates scored from the
     neighbours' coordinates: by `candidate_topt` in the fast config, which
     reads them from P and Q by node id, in torch on gathered coordinates
     (`kernels.triangles.candidates_from_points`) in the exact one;
  3. fast config (`per_anchor_candidates = T > 0`): each anchor's top-T
     candidates, then a global top-K over the A*T of them (the identity when
     A*T <= K);
     exact config: cross-anchor duplicates invalidated, canonical (lo, mid,
     hi) triples, then an exact global top-K, one launch of
     `kernels.triangles.pool_rank` on a card.

Every top-k here is a stable descending sort, `lax.top_k`'s order. Where the
JAX package asks for `approx_max_k` (approx_topk=True with A*T > K) the port
takes the exact top-K. Node ids are int64 throughout.

Under correspondence sharding (`anchor_group`) the per-anchor work of the
fast config is split over the group: each rank scores a contiguous slice of
A/d anchors and one all-gather in rank order rebuilds the unsharded pool
exactly (`saccot_tpu/engine/triangles.py:130-135, 221-236`).

`triangle_pool` builds the pool from a dense score matrix S instead (tests
and small N): degrees are the row sums of S, the anchors' top-B come from
their rows, and s_jk is read from S when no points are given. With
`num_anchors >= N` and `neighbors_per_anchor >= N - 1` its candidates are a
superset of the oracle's clique enumeration. `pair_scores` and
`edge_scores_from_points` score point pairs and edges by the shared
predicate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from saccot_tpu_torch.dist.collectives import all_gather, group_rank, group_size
from saccot_tpu_torch.engine.compat import pair_distances, pair_score
from saccot_tpu_torch.kernels import triangles as tri_kernels
from saccot_tpu_torch.kernels.triangles import topk_stable
from saccot_tpu_torch.utils.params import SacCotParams


class TrianglePool(NamedTuple):
    # [batch, K, 3] int64 node triples: canonical lo < mid < hi with dedup,
    # (anchor, nbr, nbr) without. Padded entries are (0, 0, 0).
    triples: torch.Tensor
    scores: torch.Tensor   # [batch, K] float32, -1 for padded/invalid entries
    valid: torch.Tensor    # [batch, K] bool


def pair_scores(
    pa: torch.Tensor,
    pb: torch.Tensor,
    qa: torch.Tensor,
    qb: torch.Tensor,
    params: SacCotParams,
) -> torch.Tensor:
    """Compatibility score of point pairs (pa, pb) and (qa, qb), [..., 3] ->
    [...], by `engine.compat`'s predicate (without the i != j test)."""
    return pair_score(pair_distances(pa, pb), pair_distances(qa, qb),
                      params.compat_tau, params.min_separation)


def edge_scores_from_points(
    P: torch.Tensor,
    Q: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    params: SacCotParams,
) -> torch.Tensor:
    """Compatibility score of the edges (idx_a, idx_b), gathering only their
    point rows: P, Q [..., N, 3], idx [..., E] -> [..., E]; a self-edge
    scores 0."""
    def rows(X, idx):
        return torch.gather(X, -2, idx[..., None].expand(*idx.shape, 3))

    s = pair_scores(rows(P, idx_a), rows(P, idx_b), rows(Q, idx_a), rows(Q, idx_b), params)
    return torch.where(idx_a != idx_b, s, 0.0)


def triangle_pool(
    S: torch.Tensor,
    params: SacCotParams,
    P: Optional[torch.Tensor] = None,
    Q: Optional[torch.Tensor] = None,
) -> TrianglePool:
    """Pool from a dense score matrix S [batch, N, N] (tests and small N).
    With P and Q [batch, N, 3], s_jk is scored from the points, else read
    from S."""
    batch, N, _ = S.shape
    A = min(params.num_anchors, N)
    B = min(params.neighbors_per_anchor, N - 1)
    _, anchors = topk_stable(S.sum(dim=-1), A)                      # [batch, A]
    rows = torch.gather(S, 1, anchors[..., None].expand(batch, A, N))
    nbr_s, nbr_idx = topk_stable(rows, B)                           # [batch, A, B]
    return _pool_from_neighbors(anchors, nbr_s, nbr_idx, P, Q, params, S=S)


def triangle_pool_from_points(
    P: torch.Tensor,
    Q: torch.Tensor,
    deg: torch.Tensor,
    params: SacCotParams,
    mask: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    anchor_group=None,
) -> TrianglePool:
    """Degrees and points [batch, N, 3] in, ranked triangles out.

    impl="kernel" goes through the kernel wrappers of `kernels.triangles`
    (the CUDA kernels on a card, their plain versions on the CPU);
    impl="plain" calls the plain versions on any device. Both take the
    route that N selects. `anchor_group`: the group the correspondence axis
    is sharded over; with `per_anchor_candidates > 0` and A divisible by its
    size d > 1 the anchors are split over it, every other route stays
    replicated.
    """
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    plain = impl == "plain"
    batch, N, _ = P.shape
    A = min(params.num_anchors, N)
    B = min(params.neighbors_per_anchor, N - 1)
    T = min(params.per_anchor_candidates, B * (B - 1) // 2)
    _, anchors = topk_stable(deg, A)                               # [batch, A]
    d = group_size(anchor_group)
    shard = params.per_anchor_candidates > 0 and d > 1 and A % d == 0
    # Each rank's contiguous slice of the anchors when sharded, else all.
    mine = (anchors[:, group_rank(anchor_group) * (A // d):][:, :A // d] if shard
            else anchors)
    anchor_mask = None if mask is None else torch.gather(mask, 1, mine)
    args = (P, Q, mine, B, params.compat_tau, params.min_separation)
    kw = dict(mask=mask, anchor_mask=anchor_mask)
    if N > tri_kernels.MAX_N_FUSED:
        # Stream the neighbours, then score candidates from their coordinates.
        nbr_s, nbr_idx = (tri_kernels.anchor_neighbors_reference if plain
                          else tri_kernels.anchor_neighbors_stream)(*args, **kw)
        if params.per_anchor_candidates > 0:
            cand = (tri_kernels.candidate_topt_reference if plain else tri_kernels.candidate_topt)(
                nbr_s, nbr_idx, P, Q, T, params.compat_tau, params.min_separation)
            return _pool_from_preranked(anchors, *_gather_anchors(cand, shard, anchor_group),
                                        params)
        return _pool_from_neighbors(anchors, nbr_s, nbr_idx, P, Q, params, plain=plain)
    fn = tri_kernels.anchor_neighbors_reference if plain else tri_kernels.anchor_neighbors
    if params.per_anchor_candidates > 0:
        cand = fn(*args, **kw, top_t=T)[2:]
        return _pool_from_preranked(anchors, *_gather_anchors(cand, shard, anchor_group),
                                    params)
    nbr_s, nbr_idx, cand = fn(*args, **kw, emit_candidates=True)
    return _rank_neighbor_candidates(anchors, nbr_s, nbr_idx, cand, params, N, plain)


def _gather_anchors(arrs, shard: bool, group):
    """Each rank's [batch, A/d, ...] anchor-slice results, all-gathered in
    rank order back to [batch, A, ...] when the anchors were sharded."""
    return tuple(all_gather(a, group, dim=1) for a in arrs) if shard else tuple(arrs)


def _rank_neighbor_candidates(
    anchors: torch.Tensor,   # [batch, A] anchor node ids
    nbr_s: torch.Tensor,     # [batch, A, B] neighbour scores, descending
    nbr_idx: torch.Tensor,   # [batch, A, B] neighbour node ids
    cand: torch.Tensor,      # [batch, A, Pairs] candidate scores, -1 = invalid
    params: SacCotParams,
    n_nodes: int,
    plain: bool,
) -> TrianglePool:
    """(exact dedup, canonical triples) -> global top-K of the candidates
    (anchor, b1, b2) over the pair slots: `kernels.triangles.pool_rank`, or
    its plain version."""
    fn = tri_kernels.pool_rank_reference if plain else tri_kernels.pool_rank
    return TrianglePool(*fn(anchors, nbr_s, nbr_idx, cand, params.max_hypotheses,
                            params.dedup_triangles, n_nodes))


def _pool_from_neighbors(
    anchors: torch.Tensor,   # [batch, A] anchor node ids
    nbr_s: torch.Tensor,     # [batch, A, B] neighbour scores, descending
    nbr_idx: torch.Tensor,   # [batch, A, B] neighbour node ids
    P: Optional[torch.Tensor],
    Q: Optional[torch.Tensor],
    params: SacCotParams,
    S: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> TrianglePool:
    """Candidate triangles, then ranked: the exact config above MAX_N_FUSED,
    and `triangle_pool`; `plain` ranks them by the plain version.

    s_jk is scored from the neighbours' coordinates when P and Q are given
    (direct differences; the JAX version takes `jnp.linalg.norm`, so a score
    within an ulp of tau or min_separation may decide differently), else
    read from the dense S [batch, N, N], whose diagonal may make an anchor
    its own neighbour (the id tests drop those candidates).
    """
    batch, _, B = nbr_idx.shape
    slots = tri_kernels.pair_slots(B, nbr_idx.device)
    if P is not None and Q is not None:
        n_nodes = P.shape[1]
        cand = tri_kernels.candidates_from_points(nbr_s, nbr_idx, P, Q, params.compat_tau,
                                                  params.min_separation, slots, anchors)
    else:
        if S is None:
            raise ValueError("_pool_from_neighbors needs either the points or the dense S")
        n_nodes = S.shape[-1]
        j, k = nbr_idx[:, :, slots[0]], nbr_idx[:, :, slots[1]]
        s_jk = torch.gather(S.reshape(batch, -1), 1,
                            (j * n_nodes + k).reshape(batch, -1)).reshape(j.shape)
        cand = tri_kernels.candidate_scores(nbr_s, nbr_idx, slots, s_jk, anchors)
    return _rank_neighbor_candidates(anchors, nbr_s, nbr_idx, cand, params, n_nodes, plain)


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
        return TrianglePool(*tri_kernels.pool_from_selected((i, j, k), flat_s,
                                                            params.max_hypotheses))
    return TrianglePool(*tri_kernels.select_topk((i, j, k), flat_s, params.max_hypotheses))
