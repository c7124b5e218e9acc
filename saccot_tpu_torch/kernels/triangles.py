"""Anchor top-B neighbours and candidate triangles: CUDA kernel wrapper and
its plain PyTorch version.

Replaces `saccot_tpu/kernels/triangles.py::_anchor_topb_kernel` with
`csrc/anchor_topb.cu`, in both of its output modes:
  - `emit_candidates=True`: the score of every candidate triangle
    (anchor, b1, b2), b1 < b2 in `np.triu_indices(B, k=1)` order, -1 when
    invalid (the exact config);
  - `top_t > 0`: each anchor's top-T candidates with decoded neighbour node
    ids (the fast config).
Selection order is `lax.top_k`'s: score descending, lowest index first. The
plain version gets it from a stable descending sort (`torch.topk` does not
promise it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from saccot_tpu_torch.engine.compat import cross_distances, pair_distances, pair_score
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import (
    f32_points, index_tensor, optional_mask, ptr, stream_of,
)

MAX_N_FUSED = 4096   # the anchor row lives in shared memory (16 KB)
MAX_NEIGHBORS = 32   # the B x B pair grid lives in shared memory


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lowest index — `lax.top_k`'s order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def anchor_neighbors_reference(
    P: torch.Tensor,
    Q: torch.Tensor,
    anchors: torch.Tensor,
    num_neighbors: int,
    compat_tau: float,
    min_separation: float,
    mask: Optional[torch.Tensor] = None,
    anchor_mask: Optional[torch.Tensor] = None,
    emit_candidates: bool = False,
    top_t: int = 0,
):
    """Plain version of `anchor_neighbors` (same arguments and returns)."""
    batch, N, _ = P.shape
    B = num_neighbors
    gidx = anchors[..., None].expand(*anchors.shape, 3)
    S = pair_score(cross_distances(torch.gather(P, 1, gidx), P),
                   cross_distances(torch.gather(Q, 1, gidx), Q),
                   compat_tau, min_separation)                    # [batch, A, N]
    cols = torch.arange(N, device=P.device)
    S = torch.where(anchors[..., None] == cols, 0.0, S)
    if mask is not None:
        S = S * mask.to(S.dtype)[:, None, :]
    if anchor_mask is not None:
        S = S * anchor_mask.to(S.dtype)[:, :, None]
    nbr_s, nbr_idx = topk_stable(S, B)                             # [batch, A, B]
    if not (emit_candidates or top_t):
        return nbr_s, nbr_idx

    A = anchors.shape[1]
    nidx = nbr_idx.reshape(batch, A * B, 1).expand(batch, A * B, 3)
    nbr_p = torch.gather(P, 1, nidx).reshape(batch, A, B, 3)
    nbr_q = torch.gather(Q, 1, nidx).reshape(batch, A, B, 3)
    s_jk = pair_score(pair_distances(nbr_p[:, :, :, None], nbr_p[:, :, None, :]),
                      pair_distances(nbr_q[:, :, :, None], nbr_q[:, :, None, :]),
                      compat_tau, min_separation)                  # [batch, A, B, B]
    s1, s2 = nbr_s[..., :, None], nbr_s[..., None, :]
    upper = torch.ones(B, B, dtype=torch.bool, device=P.device).triu(1)
    valid = (s1 > 0) & (s2 > 0) & (s_jk > 0) & upper
    cand3 = torch.where(valid, s1 + s2 + s_jk, -1.0)
    if not top_t:
        b1, b2 = np.triu_indices(B, k=1)
        return nbr_s, nbr_idx, cand3[:, :, b1, b2]
    v, slot = topk_stable(cand3.reshape(batch, A, B * B), top_t)
    cand_j = torch.gather(nbr_idx, 2, slot // B).clamp(0, N - 1)
    cand_k = torch.gather(nbr_idx, 2, slot % B).clamp(0, N - 1)
    return nbr_s, nbr_idx, torch.clamp_min(v, -1.0), cand_j, cand_k


def anchor_neighbors(
    P: torch.Tensor,
    Q: torch.Tensor,
    anchors: torch.Tensor,
    num_neighbors: int,
    compat_tau: float,
    min_separation: float,
    mask: Optional[torch.Tensor] = None,
    anchor_mask: Optional[torch.Tensor] = None,
    emit_candidates: bool = False,
    top_t: int = 0,
):
    """Top-B compatibility neighbours of each anchor.

    P, Q [batch, N, 3]; anchors [batch, A] int64 node ids; mask [batch, N]
    (columns) and anchor_mask [batch, A] (rows). Returns nbr_s [batch, A, B]
    float32 descending and nbr_idx [batch, A, B] int64, plus
      cand [batch, A, B(B-1)/2]                         with emit_candidates,
      cand_s, cand_j, cand_k [batch, A, T]              with top_t = T > 0.
    """
    if top_t:
        emit_candidates = True
    if not P.is_cuda:
        return anchor_neighbors_reference(
            P, Q, anchors, num_neighbors, compat_tau, min_separation, mask=mask,
            anchor_mask=anchor_mask, emit_candidates=emit_candidates, top_t=top_t)
    batch, N, _ = P.shape
    A = anchors.shape[1]
    B = num_neighbors
    if N > MAX_N_FUSED:
        raise NotImplementedError(
            f"anchor_neighbors on CUDA holds N <= {MAX_N_FUSED} (got {N}); the "
            "streaming kernel for larger N (_anchor_topb_stream_kernel) is in "
            "ROADMAP queue 2, for the large-N slice of queue 1 item 5")
    if not 1 <= B <= min(MAX_NEIGHBORS, N):
        raise NotImplementedError(
            f"anchor_neighbors on CUDA takes 1 <= B <= {MAX_NEIGHBORS} and B <= N "
            f"(got B={B}); larger B is listed in ROADMAP queue 3")
    n_pairs = B * (B - 1) // 2
    if top_t > n_pairs:
        raise ValueError(f"top_t={top_t} exceeds the {n_pairs} candidate pairs")
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    anchors = index_tensor(anchors, (batch, A), "anchors")
    mask = optional_mask(mask, batch, N, P.device)
    anchor_mask = optional_mask(anchor_mask, batch, A, P.device)
    dev = P.device
    nbr_s = torch.empty((batch, A, B), dtype=torch.float32, device=dev)
    nbr_idx = torch.empty((batch, A, B), dtype=torch.int64, device=dev)
    cand = cand_j = cand_k = None
    if top_t:
        mode, cand_cols, counter = 2, top_t, "anchor_topb_topt"
        cand = torch.empty((batch, A, top_t), dtype=torch.float32, device=dev)
        cand_j = torch.empty((batch, A, top_t), dtype=torch.int64, device=dev)
        cand_k = torch.empty((batch, A, top_t), dtype=torch.int64, device=dev)
    elif emit_candidates:
        mode, cand_cols, counter = 1, n_pairs, "anchor_topb_candidates"
        cand = torch.empty((batch, A, n_pairs), dtype=torch.float32, device=dev)
    else:
        mode, cand_cols, counter = 0, 0, "anchor_topb"
    if batch and A:
        lib = _build.library()
        rc = lib.saccot_anchor_topb(
            ptr(P), ptr(Q), ptr(anchors), ptr(mask), ptr(anchor_mask), ptr(nbr_s),
            ptr(nbr_idx), ptr(cand), ptr(cand_j), ptr(cand_k), batch, N, A, B, mode,
            top_t, cand_cols, float(compat_tau), float(np.float32(1.0 / compat_tau)),
            float(min_separation), stream_of(nbr_s),
        )
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
    # Selections carry column indices < N by construction; the clamps keep
    # the downstream gathers safe, as the TPU wrapper's do.
    nbr_idx = nbr_idx.clamp_(max=N - 1)
    if top_t:
        return nbr_s, nbr_idx, cand, cand_j.clamp_(0, N - 1), cand_k.clamp_(0, N - 1)
    if emit_candidates:
        return nbr_s, nbr_idx, cand
    return nbr_s, nbr_idx
