"""Anchor top-B neighbours and candidate triangles: CUDA kernel wrappers and
their plain PyTorch versions.

Three TPU kernels of `saccot_tpu/kernels/triangles.py` are replaced:
  - `_anchor_topb_kernel` by `csrc/anchor_topb.cu` (`anchor_neighbors`,
    N <= MAX_N_FUSED: the anchor row lives in shared memory; one warp per
    anchor, `anchor_plan` of them a block), in both of its output modes:
      `emit_candidates=True`: the score of every candidate triangle
      (anchor, b1, b2) in `pair_slots` order, -1 when invalid (the exact
      config);
      `top_t > 0`: each anchor's top-T candidates with decoded neighbour
      node ids (the fast config);
  - `_anchor_topb_stream_kernel` by `csrc/anchor_topb_stream.cu`
    (`anchor_neighbors_stream`, any N: the column axis split into chunks of
    `stream_plan`, one warp per (anchor, chunk), the chunks' top-Bs merged in
    the same launch);
  - `_candidate_topt_kernel` by `csrc/candidate_topt.cu` (`candidate_topt`:
    the top-T mode's second half, on the streamed selections; one warp per
    anchor, `candidate_plan` of them a block, reading the neighbours'
    coordinates from P and Q by node id).
One kernel replaces XLA operations of the JAX package rather than a TPU
kernel: `csrc/pool_rank.cu` (`pool_rank`: the exact pool's cross-anchor
dedup, canonical triples and global top-K, one block a pair; its plain
version, `pool_rank_reference`, is the torch composition it replaced).
Selection order is `lax.top_k`'s: score descending, lowest index first. The
plain versions get it from a stable descending sort (`torch.topk` does not
promise it).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

import numpy as np
import torch

from saccot_tpu_torch.engine.compat import cross_distances, pair_distances, pair_score
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import (
    f32_points, f32_tensor, index_tensor, optional_mask, ptr, sm_count, stream_of, tickets,
)
from saccot_tpu_torch.kernels.compat import SCRATCH_BYTES
from saccot_tpu_torch.utils import debug

MAX_N_FUSED = 4096   # the anchor row lives in shared memory (16 KB)
MAX_NEIGHBORS = 32   # the B x B pair grid lives in shared memory
# The fused kernel (csrc/anchor_topb.cu) runs one warp per anchor, at most
# MAX_WARPS warps a block. Each warp's shared region is its selections
# (WarpScratch, WARP_SCRATCH_WORDS words) and max(N, B*B) floats: the score
# row, later the pair grid. A block takes as many warps as fit in
# ANCHOR_SMEM_BUDGET bytes, the dynamic shared memory a block gets without an
# opt-in; residency per SM is then bound by the SM's shared memory, whatever W.
MAX_WARPS = 8
WARP_SCRATCH_WORDS = 8 * MAX_NEIGHBORS
ANCHOR_SMEM_BUDGET = 48 * 1024


@dataclasses.dataclass(frozen=True)
class AnchorPlan:
    """Block shape of the fused anchor kernel: `warps` anchors a block and
    its dynamic shared memory in bytes."""
    warps: int
    smem_bytes: int


def anchor_plan(N: int, B: int) -> AnchorPlan:
    """Warps per block and shared bytes of the fused anchor kernel at N
    columns and B neighbours (1 <= B <= MAX_NEIGHBORS, B <= N <= MAX_N_FUSED)."""
    if not 1 <= B <= min(MAX_NEIGHBORS, N):
        raise ValueError(f"the fused anchor kernel takes 1 <= B <= {MAX_NEIGHBORS} and B <= N "
                         f"(got B={B}, N={N})")
    if N > MAX_N_FUSED:
        raise ValueError(f"the fused anchor kernel holds the row in shared memory, N <= "
                         f"{MAX_N_FUSED} (got {N})")
    per_warp = 4 * (WARP_SCRATCH_WORDS + max(N, B * B))
    warps = max(1, min(MAX_WARPS, ANCHOR_SMEM_BUDGET // per_warp))
    return AnchorPlan(warps=warps, smem_bytes=warps * per_warp)


# The streamed kernel (csrc/anchor_topb_stream.cu) runs one warp per (anchor,
# column chunk), W warps a block (at most MAX_WARPS); each warp's shared
# region holds its chunk's scores, chunk_n floats, and a block stays within
# ANCHOR_SMEM_BUDGET. Measured on an H100 over W in {2, 4, 8} x chunk_n in
# {256, ..., 4096} (`scripts/exp_stream_plan.py`; PERF.md lists the
# readings, with those of a first form that staged each chunk's coordinates
# in shared memory and took blocks past 48 KB by opt-in): 4 warps over
# chunks of 1,024 columns read through L1 took the least device time at the
# kitti point, its anchor shard and N=5,000.
STREAM_WARPS = 4
STREAM_CHUNK_N = 1024
MAX_CHUNKS = 65535   # the grid's y extent


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Grid of the streamed anchor kernel: (tiles, chunks, batch) blocks of
    `warps` warps, one anchor a warp; chunk c covers columns
    [c chunk_n, min(N, (c + 1) chunk_n))."""
    batch: int
    tiles: int
    warps: int
    chunk_n: int
    chunks: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.chunks * self.batch

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block, as the kernel sizes it."""
        return 4 * self.warps * self.chunk_n

    def scratch_bytes(self, A: int, B: int) -> int:
        """The [batch, A, chunks, B] (score, column) lists a split plan merges."""
        return 0 if self.chunks == 1 else 8 * self.batch * A * self.chunks * B


def make_stream_plan(batch: int, A: int, N: int, warps: int, chunk_n: int) -> StreamPlan:
    """The grid of `warps` anchors a block over chunks of `chunk_n` columns."""
    chunk_n = min(chunk_n, N)
    return StreamPlan(batch=batch, tiles=-(-A // warps), warps=warps, chunk_n=chunk_n,
                      chunks=-(-N // chunk_n))


def stream_plan(batch: int, A: int, N: int, B: int, sms: int,
                chunk_n: Optional[int] = None) -> StreamPlan:
    """The streamed kernel's grid for `batch` x A anchors against N columns
    and B neighbours on a card of `sms` SMs: STREAM_WARPS anchors a block
    over chunks of STREAM_CHUNK_N columns (or `chunk_n`), with fewer warps
    where the block would pass ANCHOR_SMEM_BUDGET. Raises where one warp a
    block does not fit, or the chunks' lists would pass SCRATCH_BYTES.

    The grid does not depend on `sms`: from under one wave (N=5,000, 1,280
    blocks) to eight (kitti, 12,544) on an H100's 132 SMs, no other plan of
    the sweep took less device time."""
    del sms
    if not 1 <= B <= min(MAX_NEIGHBORS, N):
        raise ValueError(f"the streamed anchor kernel takes 1 <= B <= {MAX_NEIGHBORS} and "
                         f"B <= N (got B={B}, N={N})")
    chunk_n = STREAM_CHUNK_N if chunk_n is None else chunk_n
    if chunk_n < 1:
        raise ValueError(f"chunk_n must be positive, got {chunk_n}")
    fits = [p for p in (make_stream_plan(batch, A, N, w, chunk_n)
                        for w in range(STREAM_WARPS, 0, -1))
            if p.smem_bytes <= ANCHOR_SMEM_BUDGET]
    if not fits:
        raise ValueError(f"chunk_n={chunk_n} does not fit {ANCHOR_SMEM_BUDGET} bytes of shared "
                         "memory with one warp a block")
    plan = fits[0]
    if plan.chunks > MAX_CHUNKS or plan.scratch_bytes(A, B) > SCRATCH_BYTES:
        raise ValueError(f"{plan} needs {plan.chunks} chunks and "
                         f"{plan.scratch_bytes(A, B)} bytes of lists (at most {MAX_CHUNKS}, "
                         f"{SCRATCH_BYTES}); take larger chunks")
    return plan


# The candidate kernel (csrc/candidate_topt.cu) runs one warp per anchor, W
# warps a block; each warp's region of dynamic shared memory holds its
# selections (8 B words: scores, ids, coordinates) and the B x B pair grid,
# at most 5 KB (B = 32). Measured on an H100 over W in {1, 2, 4, 8}
# (`scripts/exp_small_kernels.py`; PERF.md lists the readings): W moved the
# device time by under 0.0002 ms at the kitti point and its anchor shard, a
# warp's own chain being what takes the time; 4 it is.
CANDIDATE_WARPS = 4


@dataclasses.dataclass(frozen=True)
class CandidatePlan:
    """Grid of the candidate kernel: (tiles, batch) blocks of `warps` warps,
    one anchor a warp, and a block's dynamic shared memory in bytes."""
    batch: int
    tiles: int
    warps: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.batch


def make_candidate_plan(batch: int, A: int, B: int, warps: int) -> CandidatePlan:
    """The grid of `warps` anchors a block over `batch` x A anchors of B
    selections."""
    return CandidatePlan(batch=batch, tiles=-(-A // warps), warps=warps,
                         smem_bytes=4 * warps * (8 * B + B * B))


def candidate_plan(batch: int, A: int, B: int) -> CandidatePlan:
    """The candidate kernel's grid for `batch` x A anchors of B selections
    (1 <= B <= MAX_NEIGHBORS): CANDIDATE_WARPS anchors a block."""
    if not 1 <= B <= MAX_NEIGHBORS:
        raise ValueError(f"the candidate kernel takes 1 <= B <= {MAX_NEIGHBORS} (got B={B})")
    return make_candidate_plan(batch, A, B, CANDIDATE_WARPS)


# The ranking kernel (csrc/pool_rank.cu) runs one block of POOL_RANK_THREADS
# threads a pair. Its dynamic shared memory (`pool_rank_smem`, the sum of
# the kernel's `layout`) holds the kept entries (8 bytes each, a power of two
# of them), the anchors as given and sorted, words per anchor and per
# selection, the neighbour ids as int32 (all, in rows of an odd stride, and
# the valid ones, in rows of a multiple of 4), the pair table and a
# histogram; and, where that still fits in an H100 block's
# POOL_RANK_SMEM_LIMIT bytes, every candidate's 4-byte key, which each pass
# of the selection then reads from shared memory instead of recomputing it
# from the scores in L2 (resident at the 3DMatch and 3DLoMatch points,
# 30,720 candidates; not at kitti's 61,440).
POOL_RANK_SMEM_LIMIT = 232448
POOL_RANK_THREADS = 1024
POOL_RANK_BINS = 256
POOL_RANK_WORDS = 8 + POOL_RANK_THREADS // 32   # the block's scalars, then one a warp
MAX_POOL_CANDIDATES = 2 ** 30


@dataclasses.dataclass(frozen=True)
class PoolRankPlan:
    """Launch of the ranking kernel: candidate keys `resident` in shared
    memory or not, the sort's width `k_pow2` and a block's dynamic shared
    memory in bytes."""
    resident: bool
    k_pow2: int
    smem_bytes: int


def pool_rank_smem(A: int, B: int, k_pow2: int, resident: bool) -> int:
    """Dynamic shared memory of a block of the ranking kernel, in bytes (the
    regions of csrc/pool_rank.cu `layout`, each rounded up to 8 bytes, the
    valid ids' and the keys' to 16)."""
    def up(n, m=8):
        return -(-n // m) * m

    n_pairs = B * (B - 1) // 2
    head = (8 * k_pow2 + 4 * up(4 * A) + up(4 * A * B) + up(4 * A * (B | 1)) + up(2 * n_pairs)
            + 4 * POOL_RANK_BINS + 4 * POOL_RANK_WORDS)
    valid_ids = 4 * A * up(B, 4)
    return up(up(head, 16) + valid_ids, 16) + (4 * A * n_pairs if resident else 0)


def pool_rank_plan(A: int, B: int, K: int) -> PoolRankPlan:
    """The ranking kernel's plan for A anchors of B selections (1 <= B <=
    MAX_NEIGHBORS) and a budget of K >= 1: the keys resident where the block
    then fits in POOL_RANK_SMEM_LIMIT bytes, else read again each pass;
    raises where neither fits."""
    if not 1 <= B <= MAX_NEIGHBORS:
        raise ValueError(f"the ranking kernel takes 1 <= B <= {MAX_NEIGHBORS} (got B={B})")
    if K < 1:
        raise ValueError(f"max_hypotheses must be at least 1, got {K}")
    n_cand = A * (B * (B - 1) // 2)
    if A < 1 or n_cand > MAX_POOL_CANDIDATES:
        raise ValueError(f"the ranking kernel takes 1 <= A and at most {MAX_POOL_CANDIDATES} "
                         f"candidates a pair (got A={A}, {n_cand})")
    k_pow2 = 1 << (max(1, min(K, n_cand)) - 1).bit_length()
    for resident in (True, False):
        smem = pool_rank_smem(A, B, k_pow2, resident)
        if smem <= POOL_RANK_SMEM_LIMIT:
            return PoolRankPlan(resident=resident, k_pow2=k_pow2, smem_bytes=smem)
    raise ValueError(f"the ranking kernel needs {smem} bytes of shared memory at A={A}, B={B}, "
                     f"K={K} (at most {POOL_RANK_SMEM_LIMIT})")


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
    if top_t:
        return (nbr_s, nbr_idx) + candidate_topt_reference(
            nbr_s, nbr_idx, P, Q, top_t, compat_tau, min_separation)
    if not emit_candidates:
        return nbr_s, nbr_idx
    return nbr_s, nbr_idx, candidates_from_points(nbr_s, nbr_idx, P, Q, compat_tau,
                                                  min_separation, pair_slots(B, P.device),
                                                  anchors)


def pair_slots(B: int, device):
    """The candidate layout, which csrc/common.cuh `candidate_grid` walks too:
    (b1, b2) int64 on `device`, the pairs b1 < b2 of B selections in
    `np.triu_indices(B, k=1)`'s row-major order."""
    return tuple(torch.triu_indices(B, B, 1, device=device))


def gather_neighbors(P: torch.Tensor, Q: torch.Tensor, nbr_idx: torch.Tensor):
    """Coordinates of the selected neighbours: nbr_idx [batch, A, B] ->
    nbr_p, nbr_q [batch, A, B, 3]."""
    batch, A, B = nbr_idx.shape
    nidx = nbr_idx.reshape(batch, A * B, 1).expand(batch, A * B, 3)
    return (torch.gather(P, 1, nidx).reshape(batch, A, B, 3),
            torch.gather(Q, 1, nidx).reshape(batch, A, B, 3))


def candidate_scores(nbr_s, nbr_idx, slots, s_jk, anchors=None) -> torch.Tensor:
    """[batch, A, Pairs] scores s_b1 + s_b2 + s_jk of the candidates (anchor,
    b1, b2) over `slots`, -1 unless all three edges are positive and the node
    ids distinct; `anchors` None where the selections exclude their anchor."""
    b1, b2 = slots
    j, k = nbr_idx[:, :, b1], nbr_idx[:, :, b2]
    s_ij, s_ik = nbr_s[:, :, b1], nbr_s[:, :, b2]
    valid = (s_ij > 0) & (s_ik > 0) & (s_jk > 0) & (j != k)
    if anchors is not None:
        valid &= (anchors[:, :, None] != j) & (anchors[:, :, None] != k)
    return torch.where(valid, s_ij + s_ik + s_jk, -1.0)


def candidates_from_points(nbr_s, nbr_idx, P, Q, compat_tau, min_separation, slots,
                           anchors=None) -> torch.Tensor:
    """`candidate_scores`, s_jk scored from the neighbours' coordinates: the
    one plain scorer of candidates."""
    b1, b2 = slots
    nbr_p, nbr_q = gather_neighbors(P, Q, nbr_idx)
    s_jk = pair_score(pair_distances(nbr_p[:, :, b1], nbr_p[:, :, b2]),
                      pair_distances(nbr_q[:, :, b1], nbr_q[:, :, b2]), compat_tau, min_separation)
    return candidate_scores(nbr_s, nbr_idx, slots, s_jk, anchors)


def candidate_topt_reference(
    nbr_s: torch.Tensor,
    nbr_idx: torch.Tensor,
    P: torch.Tensor,
    Q: torch.Tensor,
    top_t: int,
    compat_tau: float,
    min_separation: float,
):
    """Plain version of `candidate_topt` (same arguments and returns): the
    candidates ranked in the kernel's B x B grid, -1 off the pairs (its slot
    order decides ties and the ids of invalid entries)."""
    batch, A, B = nbr_s.shape
    slots = pair_slots(B, nbr_s.device)
    grid = nbr_s.new_full((batch, A, B, B), -1.0)
    grid[:, :, slots[0], slots[1]] = candidates_from_points(nbr_s, nbr_idx, P, Q, compat_tau,
                                                            min_separation, slots)
    v, slot = topk_stable(grid.reshape(batch, A, B * B), top_t)
    cand_j = torch.gather(nbr_idx, 2, slot // B)
    cand_k = torch.gather(nbr_idx, 2, slot % B)
    return torch.clamp_min(v, -1.0), cand_j, cand_k


def candidate_topt(
    nbr_s: torch.Tensor,
    nbr_idx: torch.Tensor,
    P: torch.Tensor,
    Q: torch.Tensor,
    top_t: int,
    compat_tau: float,
    min_separation: float,
):
    """Each anchor's top-T candidate triangles from its selections.

    nbr_s [batch, A, B] float32 (descending; <= 0 marks an invalid
    selection), nbr_idx [batch, A, B] int64 node ids in [0, N), P, Q
    [batch, N, 3] the points they name. Returns cand_s [batch, A, T] float32
    (max(score, -1)), cand_j, cand_k [batch, A, T] int64 node ids of each
    candidate's two neighbours: the top-T mode of `anchor_neighbors` on the
    same selections, bit for bit, under any `candidate_plan`.
    """
    if not nbr_s.is_cuda:
        return candidate_topt_reference(nbr_s, nbr_idx, P, Q, top_t, compat_tau,
                                        min_separation)
    batch, A, B = nbr_s.shape
    return _candidate(nbr_s, nbr_idx, P, Q, top_t, compat_tau, min_separation,
                      candidate_plan(batch, A, B))


def _candidate(nbr_s, nbr_idx, P, Q, top_t, compat_tau, min_separation, plan: CandidatePlan):
    """Launch `csrc/candidate_topt.cu` on the grid of `plan` (any plan of the
    shape gives the same bits)."""
    batch, A, B = nbr_s.shape
    N = P.shape[1]
    if not 1 <= B <= MAX_NEIGHBORS:
        raise ValueError(f"candidate_topt on CUDA takes 1 <= B <= {MAX_NEIGHBORS} (got {B})")
    if not 1 <= top_t <= B * (B - 1) // 2:
        raise ValueError(f"top_t={top_t} must lie in [1, {B * (B - 1) // 2}]")
    if plan != make_candidate_plan(batch, A, B, plan.warps) or not 1 <= plan.warps <= MAX_WARPS:
        raise ValueError(f"{plan} is no grid of {batch} x {A} anchors of {B} selections")
    nbr_s = f32_tensor(nbr_s, (batch, A, B), "nbr_s")
    nbr_idx = index_tensor(nbr_idx, (batch, A, B), "nbr_idx")
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    dev = nbr_s.device
    cand = torch.empty((batch, A, top_t), dtype=torch.float32, device=dev)
    cand_j = torch.empty((batch, A, top_t), dtype=torch.int64, device=dev)
    cand_k = torch.empty((batch, A, top_t), dtype=torch.int64, device=dev)
    if batch and A:
        lib = _build.library()
        rc = lib.saccot_candidate_topt(
            ptr(nbr_s), ptr(nbr_idx), ptr(P), ptr(Q), ptr(cand), ptr(cand_j), ptr(cand_k),
            batch, N, A, B, top_t, plan.warps, float(compat_tau),
            float(np.float32(1.0 / compat_tau)), float(min_separation), stream_of(cand),
        )
        _build.check(rc, "candidate_topt")
        _build.LAUNCHES["candidate_topt"] += 1
        debug.check_kernel("candidate_topt", cand)
    return cand, cand_j, cand_k


def anchor_neighbors_stream(
    P: torch.Tensor,
    Q: torch.Tensor,
    anchors: torch.Tensor,
    num_neighbors: int,
    compat_tau: float,
    min_separation: float,
    mask: Optional[torch.Tensor] = None,
    anchor_mask: Optional[torch.Tensor] = None,
    chunk_n: Optional[int] = None,
):
    """Top-B compatibility neighbours of each anchor at any N: (nbr_s
    [batch, A, B] float32 descending, nbr_idx [batch, A, B] int64).

    Same selection as `anchor_neighbors` without candidates, bit for bit,
    whatever the plan (`stream_plan`'s; `chunk_n` sets the width of the
    column chunks). The plain version is `anchor_neighbors_reference`.
    """
    if not P.is_cuda:
        return anchor_neighbors_reference(P, Q, anchors, num_neighbors, compat_tau,
                                          min_separation, mask=mask, anchor_mask=anchor_mask)
    batch, N, _ = P.shape
    plan = stream_plan(batch, anchors.shape[1], N, num_neighbors, sm_count(P.device),
                       chunk_n=chunk_n)
    return _stream(P, Q, anchors, num_neighbors, compat_tau, min_separation, mask, anchor_mask,
                   plan)


def _stream(P, Q, anchors, B, compat_tau, min_separation, mask, anchor_mask,
            plan: StreamPlan, floors: bool = True):
    """Launch `csrc/anchor_topb_stream.cu` on the grid of `plan` (any plan of
    the shape gives the same bits); `floors=False` (a timing aid of
    `scripts/exp_stream_plan.py`) keeps every chunk's B rounds."""
    batch, N, _ = P.shape
    A = anchors.shape[1]
    if not 1 <= B <= min(MAX_NEIGHBORS, N):
        raise ValueError(f"anchor_neighbors_stream on CUDA takes 1 <= B <= {MAX_NEIGHBORS} "
                         f"and B <= N (got B={B}, N={N})")
    if (plan != make_stream_plan(batch, A, N, plan.warps, plan.chunk_n)
            or not 1 <= plan.warps <= MAX_WARPS or plan.chunks > MAX_CHUNKS
            or plan.smem_bytes > ANCHOR_SMEM_BUDGET):
        raise ValueError(f"{plan} is no grid of {batch} x {A} anchors against {N} columns")
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    anchors = index_tensor(anchors, (batch, A), "anchors")
    mask = optional_mask(mask, batch, N, P.device)
    anchor_mask = optional_mask(anchor_mask, batch, A, P.device)
    dev = P.device
    nbr_s = torch.empty((batch, A, B), dtype=torch.float32, device=dev)
    nbr_idx = torch.empty((batch, A, B), dtype=torch.int64, device=dev)
    if batch and A:
        stream = stream_of(nbr_s)
        part_s = part_i = ticket_buf = floors_at = None
        if plan.chunks > 1:
            part_s = torch.empty((batch, A, plan.chunks, B), dtype=torch.float32, device=dev)
            part_i = torch.empty((batch, A, plan.chunks, B), dtype=torch.int32, device=dev)
            # (batch, anchor tile) tickets, then one zeroed floor per anchor.
            ticket_buf = tickets(dev, stream, batch * plan.tiles + batch * A)
            floors_at = ticket_buf.data_ptr() + 4 * batch * plan.tiles if floors else None
        lib = _build.library()
        rc = lib.saccot_anchor_topb_stream(
            ptr(P), ptr(Q), ptr(anchors), ptr(mask), ptr(anchor_mask), ptr(nbr_s),
            ptr(nbr_idx), ptr(part_s), ptr(part_i), ptr(ticket_buf), floors_at, batch,
            N, A, B, plan.warps, plan.chunk_n, float(compat_tau),
            float(np.float32(1.0 / compat_tau)), float(min_separation), stream,
        )
        _build.check(rc, "anchor_topb_stream")
        _build.LAUNCHES["anchor_topb_stream"] += 1
        debug.check_kernel("anchor_topb_stream", nbr_s)
    # B <= N, so every slot holds a real column; the clamp keeps downstream
    # gathers safe, as the TPU wrapper's does.
    return nbr_s, nbr_idx.clamp_(max=N - 1)


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
    if not P.is_cuda:
        return anchor_neighbors_reference(
            P, Q, anchors, num_neighbors, compat_tau, min_separation, mask=mask,
            anchor_mask=anchor_mask, emit_candidates=emit_candidates, top_t=top_t)
    batch, N, _ = P.shape
    A = anchors.shape[1]
    B = num_neighbors
    if N > MAX_N_FUSED:
        raise ValueError(
            f"anchor_neighbors on CUDA holds the anchor row in shared memory, N <= "
            f"{MAX_N_FUSED} (got {N}); larger N goes through anchor_neighbors_stream "
            "and candidate_topt, as engine.triangles.triangle_pool_from_points routes it")
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
            top_t, cand_cols, anchor_plan(N, B).warps, float(compat_tau),
            float(np.float32(1.0 / compat_tau)), float(min_separation), stream_of(nbr_s),
        )
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
        debug.check_kernel(counter, nbr_s, cand)
    # Selections carry column indices < N by construction; the clamps keep
    # the downstream gathers safe, as the TPU wrapper's do.
    nbr_idx = nbr_idx.clamp_(max=N - 1)
    if top_t:
        return nbr_s, nbr_idx, cand, cand_j.clamp_(0, N - 1), cand_k.clamp_(0, N - 1)
    if emit_candidates:
        return nbr_s, nbr_idx, cand
    return nbr_s, nbr_idx


# A ranking launch with dedup keeps each pair's count of candidates it
# invalidated as duplicates ([batch] int64 on the card, never waited on): the
# last DUPLICATES_MARKED_KEPT such launches, most recent last. A launch
# without dedup keeps nothing.
DUPLICATES_MARKED_KEPT = 64
DUPLICATES_MARKED: Deque[torch.Tensor] = deque(maxlen=DUPLICATES_MARKED_KEPT)


def mark_cross_anchor_duplicates(
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


def pool_from_selected(tri_cols, top_s: torch.Tensor, max_hypotheses: int):
    """(triples [batch, K, 3] int64, scores [batch, K], valid [batch, K]) of
    the selected triples' columns and scores, padded to the budget K with
    (0, 0, 0) and -1."""
    triples = torch.stack(tri_cols, dim=-1).to(torch.int64)
    pad = max_hypotheses - top_s.shape[1]
    if pad > 0:  # pad to the static budget
        triples = torch.cat([triples, triples.new_zeros((triples.shape[0], pad, 3))], dim=1)
        top_s = torch.cat([top_s, top_s.new_full((top_s.shape[0], pad), -1.0)], dim=1)
    return triples, top_s, top_s > 0


def select_topk(tri_cols, ss: torch.Tensor, max_hypotheses: int):
    """`pool_from_selected` of the top K of the scores ss [batch, n] (a
    stable descending sort) and their triples' columns [batch, n]."""
    top_s, top_i = topk_stable(ss, min(max_hypotheses, ss.shape[1]))
    return pool_from_selected([torch.gather(c, 1, top_i) for c in tri_cols], top_s,
                              max_hypotheses)


def pool_rank_reference(
    anchors: torch.Tensor,
    nbr_s: torch.Tensor,
    nbr_idx: torch.Tensor,
    cand: torch.Tensor,
    max_hypotheses: int,
    dedup: bool,
    n_nodes: int,
):
    """Plain version of `pool_rank` (same arguments and returns)."""
    batch, A, B = nbr_idx.shape
    b1, b2 = pair_slots(B, nbr_idx.device)
    j, k = nbr_idx[:, :, b1], nbr_idx[:, :, b2]
    if dedup:
        dup = mark_cross_anchor_duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2, n_nodes)
        cand = torch.where(dup, -1.0, cand)
    score = cand.reshape(batch, -1)
    fi, fj, fk = (x.reshape(batch, -1) for x in (anchors[:, :, None].expand_as(j), j, k))
    if not dedup:
        # Solve and scoring are permutation-invariant: keep (anchor, j, k).
        return select_topk((fi, fj, fk), score, max_hypotheses)
    a0 = torch.minimum(fi, fj)
    b0 = torch.maximum(fi, fj)
    lo2 = torch.minimum(b0, fk)
    hi = torch.maximum(b0, fk)
    lo = torch.minimum(a0, lo2)
    mid = torch.maximum(a0, lo2)
    return select_topk((lo, mid, hi), score, max_hypotheses)


def pool_rank(
    anchors: torch.Tensor,
    nbr_s: torch.Tensor,
    nbr_idx: torch.Tensor,
    cand: torch.Tensor,
    max_hypotheses: int,
    dedup: bool,
    n_nodes: int,
):
    """The exact pool from its candidates: with `dedup` the cross-anchor
    duplicates invalidated (`mark_cross_anchor_duplicates`) and the triples
    made canonical (lo, mid, hi), then the global top-K (K =
    `max_hypotheses`) in a stable descending order of the scores.

    anchors [batch, A] int64 (distinct node ids), nbr_s [batch, A, B]
    float32 (> 0 marks a valid selection), nbr_idx [batch, A, B] int64 node
    ids in [0, n_nodes) (the kernel takes n_nodes <= 2^31 - 1 and keeps the
    ids as int32), cand [batch, A, B(B-1)/2] float32 candidate scores
    in `pair_slots` order (-1 invalid). Returns triples [batch, K, 3] int64,
    scores [batch, K] float32 and valid [batch, K] bool (scores > 0), padded
    with (0, 0, 0) / -1 past the A B(B-1)/2 candidates: on CUDA tensors one
    launch of `csrc/pool_rank.cu`, which gives the plain version's bits and
    keeps its duplicate counts in `DUPLICATES_MARKED`; on CPU tensors the
    plain version.
    """
    batch, A, B = nbr_idx.shape
    shapes = {"anchors": (anchors, torch.int64, (batch, A)),
              "nbr_s": (nbr_s, torch.float32, (batch, A, B)),
              "nbr_idx": (nbr_idx, torch.int64, (batch, A, B)),
              "cand": (cand, torch.float32, (batch, A, B * (B - 1) // 2))}
    for name, (x, dtype, shape) in shapes.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != cand.device:
            raise ValueError(f"{name} on {x.device}, cand on {cand.device}")
    if max_hypotheses < 1:
        raise ValueError(f"max_hypotheses must be at least 1, got {max_hypotheses}")
    if not cand.is_cuda:
        return pool_rank_reference(anchors, nbr_s, nbr_idx, cand, max_hypotheses, dedup,
                                   n_nodes)
    if n_nodes > 2 ** 31 - 1:
        raise ValueError(f"the ranking kernel keeps node ids as int32, n_nodes <= 2^31 - 1 "
                         f"(got {n_nodes})")
    plan = pool_rank_plan(A, B, max_hypotheses)
    dev, K = cand.device, max_hypotheses
    anchors, nbr_s, nbr_idx, cand = (x.contiguous() for x in (anchors, nbr_s, nbr_idx, cand))
    triples = torch.empty((batch, K, 3), dtype=torch.int64, device=dev)
    scores = torch.empty((batch, K), dtype=torch.float32, device=dev)
    valid = torch.empty((batch, K), dtype=torch.bool, device=dev)
    dups = torch.empty(batch, dtype=torch.int64, device=dev) if dedup else None
    if batch:
        lib = _build.library()
        rc = lib.saccot_pool_rank(
            ptr(anchors), ptr(nbr_s), ptr(nbr_idx), ptr(cand), ptr(triples), ptr(scores),
            ptr(valid), ptr(dups), batch, A, B, K, plan.k_pow2, int(dedup), int(plan.resident),
            plan.smem_bytes, stream_of(scores),
        )
        _build.check(rc, "pool_rank")
        _build.LAUNCHES["pool_rank"] += 1
        debug.check_kernel("pool_rank", scores)
        if dups is not None:
            DUPLICATES_MARKED.append(dups)
    return triples, scores, valid
