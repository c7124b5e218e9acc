"""Roofline accounting for the port's kernels on one NVIDIA H100.

Counterpart of `saccot_tpu/evaluation/roofline.py`, and the one place where
every kernel bound of the port is defined (`chip_smoke.py`, PERF.md section
6 and `scripts/exp_compat_ops.py` read them from here). For each kernel row
a model gives, from the problem's shapes alone, the work the function needs
whatever implements it:

- "flops": FP32 instructions. As in the JAX module every counted operation
  is one instruction: the kernels round every operation on its own, so no
  FMA pairs two of them, and a correctly rounded root counts SQRT_OPS;
- "bytes": device memory traffic, each input read once and each output
  written once.

`stage_bound_seconds` turns a model into the least time the card could take
for it, the larger of its instructions over the FP32 instruction rate and
its bytes over the memory rate; `roofline_fraction` turns a measured time
into the fraction of that bound. A kernel's own instruction count (its loop
overhead, what its compiler adds) moves no bound: a redesign is measured
against the same yardstick as the kernel it replaces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from saccot_tpu_torch.utils.params import SacCotParams


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Peak rates of one card. Defaults: one NVIDIA H100 SXM (80 GB HBM3) at
    its full power limit of 700 W.

    The FP32 rate is the instruction issue rate: 132 SMs x 128 lanes x
    1.98 GHz (the published 67 TFLOP/s counts an FMA as two; four schedulers
    of 32 lanes per SM issue the same 128 instructions a clock of any kind).
    Device memory moves 3.35e12 bytes a second. A card set below 700 W runs
    slower under load: a fraction is meaningful only beside the power limit
    of the card that was measured (`nvidia-smi --query-gpu=name,power.limit`).
    """

    fp32_instructions_per_s: float = 132 * 128 * 1.98e9
    hbm_bytes_per_s: float = 3.35e12


PEAKS = ChipPeaks()
PEAK_FP32_INSTRUCTIONS = PEAKS.fp32_instructions_per_s
PEAK_BYTES = PEAKS.hbm_bytes_per_s

# The arithmetic of one correctly rounded square root (__fsqrt_rn): MUFU.RSQ,
# two FMUL and two FFMA of the rounding fix-up, and the two-instruction range
# check (IADD3, ISETP) that picks the fast path. As compiled for sm_90a the
# fast path issues three more, the convergence pair (BSSY, BSYNC) and the
# branch around the slow-path call: control flow, not work the function
# needs, so they are left out of the bound; `exp_compat_ops.print_sass`
# reports the compiled count.
SQRT_OPS = 7
# Instructions of one pair evaluation per mode of the degree loop's timing
# variants (row 11): two dot products (3 mul, 2 add each) or two squared
# distances (3 sub, 3 mul, 2 add each), the roots, the tail (sub, mul, sub
# or compare, min, compare, select, max: 7), the mode's final add where it
# has one, and the row accumulate (1).
MODE_OPS = {
    "gram_only": 10 + 1 + 1,
    "d2_only": 16 + 1 + 1,
    "one_sqrt": 16 + SQRT_OPS + 1 + 1,
    "no_sqrt_tail": 16 + 7 + 1,
    "full": 16 + 2 * SQRT_OPS + 7 + 1,
}
# One scored pair of the production degree and anchor kernels: `full` plus
# the i != j test and the mask multiply.
PAIR_OPS = MODE_OPS["full"] + 2
# One least-squares rigid fit of three point pairs, as the function needs it
# whatever implements it: the two centroids (18) and the centred points
# (18), the nine cross-covariance entries (45), Horn's symmetric 4x4 matrix
# (14), its dominant eigenvector (250, the count the reference module gives
# that solve), the rotation from the unit quaternion (24) and the
# translation (18). The port's own way to the eigenvector,
# eight renormalised 4x4 squarings (about 1,050), is not counted.
SOLVE_OPS = 18 + 18 + 45 + 14 + 250 + 24 + 18
# One (hypothesis, point) score: the residual (3 x 7), its square (5), the
# threshold and the count.
SCORE_OPS = 28
# One point of an inlier pass of the refine (`engine/score.inlier_mask`):
# the residual (3 x 7), its square (5), the root, the threshold and the mask.
INLIER_OPS = 21 + 5 + SQRT_OPS + 2
# One point of a weighted Umeyama fit (`engine/svd3.umeyama`): the weight
# (1), the weight sum (1), the weighted sums of p and q (12), both centred
# points (6), the weighted centred p (3) and the nine cross-covariance
# products and sums (18).
UMEYAMA_OPS = 1 + 1 + 12 + 6 + 3 + 18

Model = Dict[str, float]


def _model(flops: float, nbytes: float) -> Model:
    return {"flops": float(flops), "bytes": float(nbytes)}


def compat_degrees_model(n: int, batch: int = 1, rows: Optional[int] = None) -> Model:
    """Weighted compatibility degrees of n points (rows 1, 5 and 9), at any
    n and on any route: each unordered pair the degrees need is evaluated
    once (PAIR_OPS), with one more accumulate where both its ends are rows.
    `rows=None`: the degrees of all n points (n(n-1)/2 pairs); `rows=R`: of
    a slice of R of them (the SP slice: R(R-1)/2 pairs among the slice,
    R(n-R) to the rest), given as R further row points. Points read once,
    the degrees written once.
    """
    r = n if rows is None else rows
    pts = n if rows is None else rows + n
    flops = (PAIR_OPS + 1) * batch * r * (r - 1) // 2 + PAIR_OPS * batch * r * (n - r)
    return _model(flops, 4 * batch * (6 * pts + r))


def ring_step_model(rows: int, cols: int, batch: int = 1) -> Model:
    """One ring step of the sharded degrees (row 10): R rows against C
    columns, PAIR_OPS a pair; both packed blocks read (7 floats a point),
    the row sums read and written."""
    return _model(PAIR_OPS * batch * rows * cols, 28 * batch * (rows + cols) + 8 * batch * rows)


def anchor_rows_model(n: int, a: int, b: int, batch: int = 1) -> Model:
    """Anchor rows and their top-B neighbours (row 6, and the first part of
    row 2): each anchor scored against all n columns (PAIR_OPS and the
    self-pair test); points and anchor ids read, top-B scores and ids
    written."""
    return _model((PAIR_OPS + 1) * batch * a * n,
                  4 * batch * n * 6 + 8 * batch * a + 12 * batch * a * b)


def candidate_topt_model(a: int, b: int, t: int, batch: int = 1) -> Model:
    """Candidate scores and per-anchor top-T (row 7): each of the B(B-1)/2
    neighbour pairs of an anchor scored (PAIR_OPS, two more adds, the
    selection's compare); the neighbours' scores and ids and their nine
    coordinates read, T candidates (score and two ids) written."""
    return _model((PAIR_OPS + 4) * batch * a * b * (b - 1) // 2,
                  batch * a * b * 36 + 20 * batch * a * t)


def pool_model(n: int, a: int, b: int, t: int = 4, batch: int = 1) -> Model:
    """The fused anchor kernel (row 2): `anchor_rows_model`, then each
    anchor's B(B-1)/2 candidates scored. `t > 0` (the fast configuration):
    the top-T of each anchor's candidates selected (one compare more) and
    written; `t = 0` (the exact configuration): every candidate's score
    written."""
    rows = anchor_rows_model(n, a, b, batch)
    cands = batch * a * b * (b - 1) // 2
    if t > 0:
        return _model(rows["flops"] + (PAIR_OPS + 4) * cands, rows["bytes"] + 20 * batch * a * t)
    return _model(rows["flops"] + (PAIR_OPS + 3) * cands, rows["bytes"] + 4 * cands)


def pool_rank_model(a: int, b: int, k: int, batch: int = 1) -> Model:
    """The exact pool's ranking (row 13): dedup, canonical triples and the
    top-K of a pair's A B(B-1)/2 candidates. Integer compares, no FP32
    arithmetic; the candidate scores, the neighbours' scores and ids and the
    anchors read once, K triples, scores and flags and the duplicate count
    written."""
    cands = a * b * (b - 1) // 2
    return _model(0, batch * (4 * cands + 12 * a * b + 8 * a + 29 * k + 8))


def solve_model(n: int, k: int, batch: int = 1) -> Model:
    """The 3-point solves (rows 3, 8): SOLVE_OPS a hypothesis; the triples
    read, the point rows they name (at most 3K of n), r9 and t3 written."""
    return _model(SOLVE_OPS * batch * k,
                  24 * batch * k + 24 * batch * min(n, 3 * k) + 48 * batch * k)


def scoring_model(n: int, k: int, batch: int = 1) -> Model:
    """Hypothesis scoring (row 4): K transforms x n points, SCORE_OPS each;
    points and transforms read, scores and counts written."""
    return _model(SCORE_OPS * batch * k * n, 24 * batch * n + 48 * batch * k + 8 * batch * k)


def compat_ops_model(mode: str, form: str, n: int, batch: int = 1) -> Model:
    """One timing variant of the degree loop (row 11): the two-sided form
    evaluates all n^2 pairs; the tri form each unordered pair and each self
    pair once, adding one column accumulate per evaluation. Points read
    once, sums written once."""
    if form == "tri":
        ops = (MODE_OPS[mode] + 1) * batch * n * (n + 1) // 2
    else:
        ops = MODE_OPS[mode] * batch * n * n
    return _model(ops, 4 * batch * n * 7)


def refine_model(n: int, refine_iters: int, batch: int = 1) -> Model:
    """The refine after the best hypothesis (`engine/sac_cot.refine`):
    `refine_iters + 1` inlier passes and `refine_iters` weighted Umeyama
    fits over n points (the 4 x 4 Horn solves per pair are left out: O(1)
    a fit); points and the mask read, the inlier mask written."""
    return _model(batch * n * ((refine_iters + 1) * INLIER_OPS + refine_iters * UMEYAMA_OPS),
                  batch * n * (4 * 7 + 1))


def estimator_models(n: int, params: SacCotParams, batch: int = 1) -> Dict[str, Model]:
    """The model of each stage of one `register_batch` call of `batch`
    pairs of n correspondences: degrees, pool, solve, score, refine, each
    the same function on either route (above 2,048 points the symmetric
    degree kernel runs, above 4,096 the pool's work is split over rows 6
    and 7)."""
    a = min(params.num_anchors, n)
    b = min(params.neighbors_per_anchor, n - 1)
    t = min(params.per_anchor_candidates, b * (b - 1) // 2)
    k = params.max_hypotheses
    return {
        "degrees": compat_degrees_model(n, batch),
        "pool": pool_model(n, a, b, t, batch),
        "solve": solve_model(n, k, batch),
        "score": scoring_model(n, k, batch),
        "refine": refine_model(n, params.refine_iters, batch),
    }


def estimator_flop_count(n: int, params: SacCotParams, batch: int = 1) -> float:
    """Total FP32 instructions of one estimator invocation: rows 1-4 and the
    refine (`estimator_models`)."""
    return sum(m["flops"] for m in estimator_models(n, params, batch).values())


def _bounds(model: Model, peaks: ChipPeaks) -> Tuple[float, float]:
    """(instruction bound, memory bound) of a model, in seconds."""
    return (model["flops"] / peaks.fp32_instructions_per_s,
            model["bytes"] / peaks.hbm_bytes_per_s)


def stage_bound_seconds(model: Model, peaks: ChipPeaks = PEAKS) -> float:
    """Speed-of-light time of a model: the larger of its instruction and
    its memory bound."""
    return max(_bounds(model, peaks))


def bound_ms(model: Model, peaks: ChipPeaks = PEAKS) -> Tuple[float, str]:
    """(ms, what bounds it: "operations" or "bytes") of a model, as the
    kernel table of `chip_smoke.py` and PERF.md print it."""
    t_ops, t_bytes = _bounds(model, peaks)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def roofline_fraction(model: Model, measured_seconds: float,
                      peaks: ChipPeaks = PEAKS) -> Dict[str, float]:
    """Compare a measured time against the model's compute and memory
    bounds: the two bound times, which resource binds, and the achieved
    fraction of that bound (1.0 = speed of light; above 1 the model
    overcounts the work)."""
    t_compute, t_memory = _bounds(model, peaks)
    return {
        "compute_bound_s": t_compute,
        "memory_bound_s": t_memory,
        "binding": "compute" if t_compute >= t_memory else "memory",
        "fraction_of_peak": max(t_compute, t_memory) / max(measured_seconds, 1e-12),
        "measured_s": measured_seconds,
    }
