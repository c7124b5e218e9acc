"""Hypothesis scoring: CUDA kernel wrapper and its plain PyTorch version.

Replaces `saccot_tpu/kernels/score.py::_score_kernel` with `csrc/score.cu`.
Hypotheses arrive in the solve's native layout, rotations `r9 [batch, 9, K]`
(row-major entries) and translations `t3 [batch, 3, K]`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from saccot_tpu_torch.engine import score as score_mod
from saccot_tpu_torch.engine.score import reduce_scores
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import f32_points, optional_mask, ptr, stream_of


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
    scores = torch.empty((batch, K), dtype=torch.float32, device=P.device)
    counts = torch.empty((batch, K), dtype=torch.int32, device=P.device)
    if batch == 0 or K == 0:
        return scores, counts
    lib = _build.library()
    rc = lib.saccot_score(
        ptr(r9), ptr(t3), ptr(P), ptr(Q), ptr(mask), ptr(scores), ptr(counts),
        batch, N, K, float(np.float32(tau * tau)), float(np.float32(1.0 / tau)),
        int(mode == "weighted"), stream_of(scores),
    )
    _build.check(rc, "score")
    _build.LAUNCHES["score"] += 1
    if group is None:
        return scores, counts
    return reduce_scores(counts, scores if mode == "weighted" else None, group)
