"""Hypothesis scoring: CUDA kernel wrapper and its plain PyTorch version.

Replaces `saccot_tpu/kernels/score.py::_score_kernel` with `csrc/score.cu`.
Hypotheses arrive in the solve's native layout, rotations `r9 [batch, 9, K]`
(row-major entries) and translations `t3 [batch, 3, K]`. `score_plan` decides
how the kernel's grid covers (batch, K, N) on a card of a given SM count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from saccot_tpu_torch.engine import score as score_mod
from saccot_tpu_torch.engine.score import reduce_scores
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import (
    f32_points, optional_mask, ptr, sm_count, stream_of, tickets,
)
from saccot_tpu_torch.utils import debug


# The kernel's block: 128 threads, two hypotheses each (csrc/score.cu kThreads,
# kHyp). Weights are summed over SEGMENT points at a time (kPointTile), then
# segment by segment, so a split's chunk is a whole number of segments.
THREADS = 128
HYP_PER_THREAD = 2
HYP_TILE = THREADS * HYP_PER_THREAD
SEGMENT = 256
# A hypothesis grid of at least FULL_BLOCKS_PER_SM blocks a SM (12 warps)
# fills the card and takes one split; a smaller one splits the point axis
# into the largest chunks of whole segments that give at least
# SPLIT_BLOCKS_PER_SM blocks a SM (16 warps, all resident at once), or into
# single segments where N has too few.
FULL_BLOCKS_PER_SM = 3
SPLIT_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class ScorePlan:
    """Grid of the score kernel: (tiles, splits, batch) blocks; split s
    covers points [s * chunk, min(N, (s + 1) * chunk))."""
    batch: int
    tiles: int
    splits: int
    chunk: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits * self.batch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def score_plan(batch: int, K: int, N: int, sms: int) -> ScorePlan:
    """The score kernel's grid for `batch` x K hypotheses against N points
    on a card with `sms` SMs."""
    tiles = _cdiv(K, HYP_TILE)
    base = max(1, tiles * batch)
    segments = _cdiv(N, SEGMENT)
    if base >= FULL_BLOCKS_PER_SM * sms or segments <= 1:
        return ScorePlan(batch=batch, tiles=tiles, splits=1, chunk=max(1, N))
    want = _cdiv(SPLIT_BLOCKS_PER_SM * sms, base)    # >= 2 here
    # cdiv(N, chunk) >= want  <=>  chunk * (want - 1) < N
    chunk = SEGMENT * max(1, (N - 1) // (SEGMENT * (want - 1)))
    return ScorePlan(batch=batch, tiles=tiles, splits=_cdiv(N, chunk), chunk=chunk)


def weighted_rtol(N: int) -> float:
    """Relative distance allowed between the kernel's weighted scores and
    torch's sum of the same non-negative terms: each side's error is at most
    u = 2^-24 per addition made in sequence. The kernel adds at most SEGMENT
    terms, then ceil(N / SEGMENT) segments; torch's reduction fewer than
    1,000 per thread, then its tree."""
    return (SEGMENT + _cdiv(N, SEGMENT) + 1000) * 2.0 ** -24


def _check_hyp(x: torch.Tensor, rows: int, batch: int, name: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 3 or x.shape[:2] != (batch, rows):
        raise ValueError(f"{name} must be a float32 CUDA tensor [batch, {rows}, K], "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def score_hypotheses_reference(
    r9: torch.Tensor,
    t3: torch.Tensor,
    P: torch.Tensor,
    Q: torch.Tensor,
    tau: float,
    mask: Optional[torch.Tensor] = None,
    mode: str = "count",
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `engine.score.score_hypotheses` on the SoA layout."""
    batch, _, K = r9.shape
    R = r9.permute(0, 2, 1).reshape(batch, K, 3, 3)
    return score_mod.score_hypotheses(R, t3.permute(0, 2, 1), P, Q, tau,
                                      mask=mask, mode=mode, group=group)


def score_hypotheses(
    r9: torch.Tensor,
    t3: torch.Tensor,
    P: torch.Tensor,
    Q: torch.Tensor,
    tau: float,
    mask: Optional[torch.Tensor] = None,
    mode: str = "count",
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [batch, K] f32, counts [batch, K] int32) of each hypothesis
    against its batch element's points P, Q [batch, N, 3]; a point with
    mask <= 0 counts nothing. With a `group`, P and Q are one shard of the
    correspondence axis and the kernel's counts and weights are summed over
    the group."""
    if mode not in ("count", "weighted"):
        raise ValueError(f"unknown scoring mode: {mode!r}")
    if not r9.is_cuda:
        return score_hypotheses_reference(r9, t3, P, Q, tau, mask=mask, mode=mode, group=group)
    batch, _, K = r9.shape
    N = P.shape[1]
    r9 = _check_hyp(r9, 9, batch, "r9")
    t3 = _check_hyp(t3, 3, batch, "t3")
    if t3.shape[2] != K:
        raise ValueError(f"t3 has {t3.shape[2]} hypotheses, r9 {K}")
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    mask = optional_mask(mask, batch, N, P.device)
    dev = P.device
    scores = torch.empty((batch, K), dtype=torch.float32, device=dev)
    counts = torch.empty((batch, K), dtype=torch.int32, device=dev)
    if batch == 0 or K == 0:
        return scores, counts
    weighted = mode == "weighted"
    plan = score_plan(batch, K, N, sm_count(dev))
    stream = stream_of(scores)
    part_c = part_w = ticket_buf = None
    if plan.splits > 1:
        part_c = torch.empty((batch, plan.splits, K), dtype=torch.int32, device=dev)
        if weighted:
            part_w = torch.empty((batch, _cdiv(N, SEGMENT), K), dtype=torch.float32, device=dev)
        # One ticket per (batch, hypothesis tile); the tile's last block sums
        # the splits.
        ticket_buf = tickets(dev, stream, batch * plan.tiles)
    lib = _build.library()
    rc = lib.saccot_score(
        ptr(r9), ptr(t3), ptr(P), ptr(Q), ptr(mask), ptr(scores), ptr(counts), ptr(part_c),
        ptr(part_w), ptr(ticket_buf), batch, N, K, plan.splits, plan.chunk,
        float(np.float32(tau * tau)), float(np.float32(1.0 / tau)), int(weighted), stream,
    )
    _build.check(rc, "score")
    _build.LAUNCHES["score"] += 1
    debug.check_kernel("score", scores)
    if group is None:
        return scores, counts
    return reduce_scores(counts, scores if mode == "weighted" else None, group)
