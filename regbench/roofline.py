"""The benchmark's yardstick: peaks of one H100 and the work of each stage.

A frozen copy of the port's roofline models (`saccot_tpu_torch/evaluation/
roofline.py` as of the benchmark's first version). The per-layer roofline
metrics read their bounds from here, never from the program, so a later
change that replaces or fuses a kernel is still measured against the same
work. For each stage a model gives, from the problem's shapes alone, the
work the function needs whatever implements it:

- "flops": FP32 instructions. Every counted operation is one instruction:
  the kernels round every operation on its own, so no FMA pairs two of them,
  and a correctly rounded root counts SQRT_OPS;
- "bytes": device memory traffic, each input read once and each output
  written once.

`bound_seconds` is the least time the card could take for a model: the
larger of its instructions over the FP32 instruction rate and its bytes over
the memory rate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Peak rates of one NVIDIA H100 SXM (80 GB HBM3) at its full power
    limit of 700 W.

    The FP32 rate is the instruction issue rate: 132 SMs x 128 lanes x
    1.98 GHz (the published 67 TFLOP/s counts an FMA as two; four schedulers
    of 32 lanes per SM issue the same 128 instructions a clock of any kind).
    Device memory moves 3.35e12 bytes a second. A card set below 700 W runs
    slower under load: a share is meaningful only beside the power limit of
    the card that was measured.
    """

    fp32_instructions_per_s: float = 132 * 128 * 1.98e9
    hbm_bytes_per_s: float = 3.35e12


PEAKS = ChipPeaks()

# One correctly rounded square root: MUFU.RSQ, two FMUL and two FFMA of the
# rounding fix-up, and the two-instruction range check of the fast path.
SQRT_OPS = 7
# One scored pair of the degree and anchor kernels: two squared distances
# (3 sub, 3 mul, 2 add each), the two roots, the tail (sub, mul, sub or
# compare, min, compare, select, max: 7), the row accumulate (1), the i != j
# test and the mask multiply (2).
PAIR_OPS = 16 + 2 * SQRT_OPS + 7 + 1 + 2
# One least-squares rigid fit of three point pairs: the two centroids (18)
# and the centred points (18), the nine cross-covariance entries (45),
# Horn's symmetric 4x4 matrix (14), its dominant eigenvector (250), the
# rotation from the unit quaternion (24) and the translation (18).
SOLVE_OPS = 18 + 18 + 45 + 14 + 250 + 24 + 18
# One (hypothesis, point) score: the residual (3 x 7), its square (5), the
# threshold and the count.
SCORE_OPS = 28
Model = Dict[str, float]


def _model(flops: float, nbytes: float) -> Model:
    return {"flops": float(flops), "bytes": float(nbytes)}


def compat_degrees_model(n: int, batch: int = 1) -> Model:
    """Weighted compatibility degrees of n points, on any route: each
    unordered pair evaluated once (PAIR_OPS) with one more accumulate, as
    both its ends are rows. Points read once, the degrees written once."""
    return _model((PAIR_OPS + 1) * batch * n * (n - 1) // 2, 4 * batch * (6 * n + n))


def anchor_rows_model(n: int, a: int, b: int, batch: int = 1) -> Model:
    """Anchor rows and their top-B neighbours (the streamed anchor kernel,
    and the first part of the fused one): each anchor scored against all n
    columns (PAIR_OPS and the self-pair test); points and anchor ids read,
    top-B scores and ids written."""
    return _model((PAIR_OPS + 1) * batch * a * n,
                  4 * batch * n * 6 + 8 * batch * a + 12 * batch * a * b)


def pool_model(n: int, a: int, b: int, batch: int = 1) -> Model:
    """The fused anchor kernel of the exact pool: `anchor_rows_model`, then
    each anchor's B(B-1)/2 candidates scored (PAIR_OPS, two adds and the
    validity test) and every candidate's score written."""
    rows = anchor_rows_model(n, a, b, batch)
    cands = batch * a * b * (b - 1) // 2
    return _model(rows["flops"] + (PAIR_OPS + 3) * cands, rows["bytes"] + 4 * cands)


def solve_model(n: int, k: int, batch: int = 1) -> Model:
    """The 3-point solves: SOLVE_OPS a hypothesis; the triples read, the
    point rows they name (at most 3K of n), r9 and t3 written."""
    return _model(SOLVE_OPS * batch * k,
                  24 * batch * k + 24 * batch * min(n, 3 * k) + 48 * batch * k)


def scoring_model(n: int, k: int, batch: int = 1) -> Model:
    """Hypothesis scoring: K transforms x n points, SCORE_OPS each; points
    and transforms read, scores and counts written."""
    return _model(SCORE_OPS * batch * k * n, 24 * batch * n + 48 * batch * k + 8 * batch * k)


def bound_seconds(model: Model, peaks: ChipPeaks = PEAKS) -> float:
    """Speed-of-light time of a model: the larger of its instruction and
    its memory bound."""
    return max(model["flops"] / peaks.fp32_instructions_per_s,
               model["bytes"] / peaks.hbm_bytes_per_s)


def stage_share(timeline, batch_models):
    """A stage's share of its roofline, in percent: the bounds of the work
    of every launch of the stage's kernels over their device seconds.
    `batch_models`: {kernel name: the model of one launch, or None for a
    kernel whose work another kernel's model already counts}. None when no
    kernel of the stage ran."""
    seconds, _ = timeline.seconds_of(batch_models)
    bound = 0.0
    for kernel, model in batch_models.items():
        if model is not None:
            bound += bound_seconds(model) * timeline.seconds_of([kernel])[1]
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
