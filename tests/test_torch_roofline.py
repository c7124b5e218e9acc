"""The port's roofline (`saccot_tpu_torch.evaluation.roofline`): the bound of
every kernel row at its shapes as PERF.md section 6 prints it, the
accounting tests/test_baselines.py holds the JAX module to, and the one
place where bounds are defined."""

import ast
import dataclasses
from pathlib import Path

import pytest

from saccot_tpu_torch.evaluation import roofline as rl
from saccot_tpu_torch.utils.params import SacCotParams

REPO = Path(__file__).resolve().parents[1]
BENCH = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=256,
                     neighbors_per_anchor=12, max_hypotheses=1024)
FAST = dataclasses.replace(BENCH, dedup_triangles=False, approx_topk=True,
                           per_anchor_candidates=4)

# Each kernel row of PERF.md section 6 at the shapes chip_smoke.py gives it:
# (model, bound ms as printed there, what bounds it). Rows 1-4 at the bench
# point (128 x N=1,000, A=256, B=12, T=4, K=1,024; row 4 also at kitti),
# 5-8 at kitti (2 x N=50,000, A=512, B=16, T=4, K=2,048), 9 the SP slice
# (32 x 1,024 rows against 2,048), 10 one ring step (2 x 25,000 x 25,000),
# 11 one pair at N=50,000 in both forms, 13 the pool's ranking at the
# threedmatch.sweep (1,623 x A=256, B=16, K=2,048) and kitti.sweep (64 x
# A=512) calls.
ROWS = {
    "1 compat_degrees": (rl.compat_degrees_model(1000, 128), "0.0784", "operations"),
    "2 anchor_topb candidates": (rl.pool_model(1000, 256, 12, 0, 128), "0.0429", "operations"),
    "2 anchor_topb top-T": (rl.pool_model(1000, 256, 12, 4, 128), "0.0430", "operations"),
    "3 solve3": (rl.solve_model(1000, 1024, 128), "0.0037", "bytes"),
    "4 score": (rl.scoring_model(1000, 1024, 128), "0.1097", "operations"),
    "4 score kitti": (rl.scoring_model(50000, 2048, 2), "0.1714", "operations"),
    "5 compat_degrees_tri": (rl.compat_degrees_model(50000, 2), "3.0638", "operations"),
    "6 anchor_topb_stream": (rl.anchor_rows_model(50000, 512, 16, 2), "0.0627", "operations"),
    "7 candidate_topt": (rl.candidate_topt_model(512, 16, 4, 2), "0.0002", "bytes"),
    "8 solve3 large N": (rl.solve_model(50000, 2048, 2), "0.0002", "bytes"),
    "9 compat_degrees_direct": (rl.compat_degrees_model(2048, 32, rows=1024), "0.0607",
                                "operations"),
    "10 ring_degrees": (rl.ring_step_model(25000, 25000, 2), "1.4946", "operations"),
    "11 compat_ops tri": (rl.compat_ops_model("full", "tri", 50000), "1.4573", "operations"),
    "11 compat_ops two-sided": (rl.compat_ops_model("full", "two_sided", 50000), "2.8397",
                                "operations"),
    "13 pool_rank": (rl.pool_rank_model(256, 16, 2048, 1623), "0.1131", "bytes"),
    "13 pool_rank kitti": (rl.pool_rank_model(512, 16, 2048, 64), "0.0078", "bytes"),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_bound_of_each_kernel_row(row):
    model, printed, by = ROWS[row]
    ms, got_by = rl.bound_ms(model)
    assert (f"{ms:.4f}", got_by) == (printed, by)
    assert rl.stage_bound_seconds(model) * 1e3 == ms


def test_peaks_are_one_h100_at_700_w():
    peaks = rl.ChipPeaks()
    assert peaks.fp32_instructions_per_s == 132 * 128 * 1.98e9 == rl.PEAK_FP32_INSTRUCTIONS
    assert peaks.hbm_bytes_per_s == 3.35e12 == rl.PEAK_BYTES
    assert {f.name for f in dataclasses.fields(peaks)} == {"fp32_instructions_per_s",
                                                           "hbm_bytes_per_s"}
    # A card below its limit: a slower peak, a longer bound.
    slow = rl.ChipPeaks(fp32_instructions_per_s=peaks.fp32_instructions_per_s / 2)
    model = ROWS["1 compat_degrees"][0]
    assert rl.stage_bound_seconds(model, slow) == 2 * rl.stage_bound_seconds(model)


def test_roofline_model_accounting():
    """As tests/test_baselines.py::test_roofline_model_accounting holds the
    JAX module: binding resource, fraction-of-peak arithmetic, the scoring
    count and the estimator's total."""
    m = rl.compat_degrees_model(n=1000, batch=32)
    assert m["flops"] == (rl.PAIR_OPS + 1) * 32 * 1000 * 999 // 2 == 41 * 32 * 499500
    assert m["bytes"] == 32 * 7000 * 4.0
    # A slice of R rows: its own pairs once, R(n - R) pairs to the other
    # points; at R = n the count of the whole, the slice's points read again.
    half = rl.compat_degrees_model(n=1000, batch=32, rows=500)
    assert half["flops"] == 32 * (41 * 500 * 499 // 2 + 40 * 500 * 500)
    whole = rl.compat_degrees_model(n=1000, batch=32, rows=1000)
    assert whole["flops"] == m["flops"] and whole["bytes"] == 32 * (6 * 2000 + 1000) * 4.0
    # O(N^2) compute vs O(N) traffic: compute-bound by orders of magnitude.
    r = rl.roofline_fraction(m, measured_seconds=1e-3)
    assert r["binding"] == "compute"
    expect = m["flops"] / rl.PEAKS.fp32_instructions_per_s / 1e-3
    assert abs(r["fraction_of_peak"] - expect) < 1e-9
    assert r["measured_s"] == 1e-3 and r["compute_bound_s"] > r["memory_bound_s"]
    # The refine reads its points once for a few operations each: memory-bound.
    ref = rl.roofline_fraction(rl.refine_model(1000, 2, 32), measured_seconds=1e-3)
    assert ref["binding"] == "memory"
    assert ref["fraction_of_peak"] == ref["memory_bound_s"] / 1e-3

    s = rl.scoring_model(n=1000, k=1024, batch=1)
    assert s["flops"] == 28.0 * 1024 * 1000

    total = rl.estimator_flop_count(1000, BENCH)
    assert total > m["flops"] / 32  # degrees are included
    stages = rl.estimator_models(1000, BENCH)
    assert list(stages) == ["degrees", "pool", "solve", "score", "refine"]
    assert total == sum(x["flops"] for x in stages.values())
    assert rl.estimator_flop_count(1000, BENCH, batch=128) == 128 * total


def test_estimator_models_count_the_functions():
    """Each stage counts its function whatever route runs it: the degrees
    the same count below and above 2,048 points, the solve SOLVE_OPS a
    hypothesis (a 3-point fit, not the CUDA kernel's squarings); the pool
    counts the top-T (fast) or every candidate (exact); A and B are capped
    by N as the pool caps them; the refine counts refine_iters + 1 inlier
    passes and refine_iters fits."""
    big = rl.estimator_models(50000, BENCH, 2)
    assert big["degrees"] == rl.compat_degrees_model(50000, 2)
    assert big["degrees"]["flops"] == 41 * 2 * 50000 * 49999 // 2
    assert rl.SOLVE_OPS == 387
    assert big["solve"]["flops"] == 387 * 2 * 1024
    small = rl.estimator_models(1000, BENCH, 128)
    assert small["degrees"] == rl.compat_degrees_model(1000, 128)
    assert small["pool"] == rl.pool_model(1000, 256, 12, 0, 128)
    assert rl.estimator_models(1000, FAST, 128)["pool"] == rl.pool_model(1000, 256, 12, 4, 128)
    assert rl.estimator_models(100, BENCH)["pool"] == rl.pool_model(100, 100, 12, 0)
    assert rl.estimator_models(8, BENCH)["pool"] == rl.pool_model(8, 8, 7, 0)
    r = rl.refine_model(1000, 2)
    assert r["flops"] == 1000 * (3 * rl.INLIER_OPS + 2 * rl.UMEYAMA_OPS)
    assert rl.refine_model(1000, 0)["flops"] == 1000 * rl.INLIER_OPS


# Constants and cost formulas that live in evaluation/roofline and nowhere else.
YARDSTICK = {"PEAK_FP32_INSTRUCTIONS", "PEAK_BYTES", "SQRT_OPS", "MODE_OPS", "PAIR_OPS",
             "SOLVE_OPS", "SCORE_OPS"}
COST_FUNCTIONS = {"cost", "degrees_cost", "solve_cost", "score_cost", "anchor_cost"}


def test_bounds_are_defined_in_the_roofline_only():
    """No other file of the port, nor chip_smoke.py, assigns a yardstick
    constant or defines a cost function of its own; chip_smoke.py and the
    attribution script import the roofline."""
    files = sorted((REPO / "saccot_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    own = REPO / "saccot_tpu_torch" / "evaluation" / "roofline.py"
    bad = []
    for f in files:
        if f == own:
            continue
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Assign):
                names = {t.id for t in node.targets if isinstance(t, ast.Name)}
                bad += [f"{f.name}: {n}" for n in names & YARDSTICK]
            elif isinstance(node, ast.FunctionDef) and node.name in COST_FUNCTIONS:
                bad.append(f"{f.name}: def {node.name}")
    assert not bad, bad
    for f in ("chip_smoke.py", "saccot_tpu_torch/scripts/exp_compat_ops.py"):
        assert "saccot_tpu_torch.evaluation" in (REPO / f).read_text(), f
