"""The port's NumPy oracle (`saccot_tpu_torch.oracle`) against the JAX
package's (`saccot_tpu.oracle`): the same arrays from the same NumPy inputs.
Then the port's estimator against its own oracle, as tests/test_engine.py
and tests/test_torch_sac_cot.py hold the estimators to the JAX oracle."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import saccot_tpu.oracle as joracle_pkg
import saccot_tpu_torch.oracle as toracle_pkg
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.oracle import saccot as joracle
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch import SacCotParams, register_batch, register_pair
from saccot_tpu_torch.evaluation.metrics import registration_recall
from saccot_tpu_torch.oracle import saccot as toracle
from saccot_tpu_torch.utils import se3np
from saccot_tpu_torch.utils.convert import problem_batch, recall, result_to_numpy, to_torch

torch.set_num_threads(2)

SMALL = dict(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=64,
             neighbors_per_anchor=10, max_hypotheses=256)
# The bench point's exact configuration (`chip_smoke.py` phase 14 (a)).
BENCH_EXACT = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
                           num_anchors=256, neighbors_per_anchor=12, max_hypotheses=1024)
# phase 14 (a)'s tolerances on T per pair, oracle against the card, with
# its rotation metric (`se3np.rotation_distance_deg`).
ORACLE_ROT_DEG, ORACLE_TRANS = 1e-3, 1e-4


def _assert_results_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_oracle_package_exports_the_jax_packages_names():
    names = ("compat_scores", "enumerate_triangles", "umeyama", "count_inliers", "sac_cot")
    for name in names:
        assert getattr(toracle_pkg, name) is getattr(toracle, name)
        assert hasattr(joracle_pkg, name)
    public = {n for n in vars(toracle_pkg) if not n.startswith("_") and n != "saccot"}
    assert public == set(names)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_oracle_gives_the_jax_oracles_arrays(seed):
    """compat_scores, enumerate_triangles, umeyama, count_inliers and
    sac_cot (count and weighted scoring, with and without a mask): equal
    arrays."""
    n = 160
    prob = correspondence_problem(seed=seed, n=n, outlier_ratio=0.6, noise=0.004)
    P, Q = prob["P"], prob["Q"]
    mask = np.arange(n) % 9 != 4
    for scoring in ("count", "weighted"):
        tp = SacCotParams(**SMALL, scoring=scoring)
        jp = JaxSacCotParams(**SMALL, scoring=scoring)
        for m in (None, mask):
            S = toracle.compat_scores(P, Q, tp, m)
            np.testing.assert_array_equal(S, joracle.compat_scores(P, Q, jp, m))
            got, want = toracle.enumerate_triangles(S), joracle.enumerate_triangles(S)
            assert got[0].shape[0] > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            _assert_results_equal(toracle.sac_cot(P, Q, tp, m), joracle.sac_cot(P, Q, jp, m))
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=n)
    for weights in (None, w):
        for a, b in zip(toracle.umeyama(P, Q, weights), joracle.umeyama(P, Q, weights)):
            np.testing.assert_array_equal(a, b)
    R, t = prob["T_gt"][:3, :3], prob["T_gt"][:3, 3]
    for m in (None, mask):
        got = toracle.count_inliers(R, t, P, Q, 0.03, m)
        want = joracle.count_inliers(R, t, P, Q, 0.03, m)
        assert got[0] == want[0] > 0
        np.testing.assert_array_equal(got[1], want[1])


def test_register_matches_the_ports_oracle_exhaustive():
    """Exhaustive regime (A >= N, B >= N-1): the pool is a superset of the
    oracle's clique enumeration, so the registrations agree."""
    n = 96
    params = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
                          num_anchors=n, neighbors_per_anchor=n - 1, max_hypotheses=512)
    prob = correspondence_problem(seed=11, n=n, outlier_ratio=0.5, noise=0.004)
    want = toracle.sac_cot(prob["P"], prob["Q"], params)
    P, Q = to_torch(prob["P"], prob["Q"], device="cpu")
    got = result_to_numpy(register_pair(P, Q, params))
    assert bool(got.success)
    E = got.T.astype(np.float64) @ np.linalg.inv(want["T"])
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.1
    assert np.linalg.norm(E[:3, 3]) < 1e-3
    assert abs(int(got.num_inliers) - want["num_inliers"]) <= 1
    E2 = got.T.astype(np.float64) @ np.linalg.inv(prob["T_gt"])
    assert se3np.rotation_angle_deg(E2[:3, :3]) < 2.0


def test_bench_point_tolerances_hold_on_the_cpu_route():
    """phase 14 (a) of chip_smoke.py on the CPU route: the 4 bench-point
    pairs (seeds 1000-1003, exact configuration) give the oracle's recall,
    T within the stated tolerances and inliers within 1."""
    P, Q, T_gt = problem_batch(range(1000, 1004), device="cpu", n=1000, outlier_ratio=0.8,
                               noise=0.004)
    res = register_batch(P, Q, BENCH_EXACT)
    want = [toracle.sac_cot(P[b].numpy(), Q[b].numpy(), BENCH_EXACT) for b in range(4)]
    Tw = [w["T"] for w in want]
    assert recall(res, T_gt, 5.0, 0.05) == registration_recall(zip(Tw, T_gt), 5.0, 0.05) == 1.0
    T = res.T.numpy().astype(np.float64)
    for b in range(4):
        assert se3np.rotation_distance_deg(T[b][:3, :3], Tw[b][:3, :3]) <= ORACLE_ROT_DEG
        assert np.linalg.norm(T[b][:3, 3] - Tw[b][:3, 3]) <= ORACLE_TRANS
        assert abs(int(res.num_inliers[b]) - want[b]["num_inliers"]) <= 1


def test_rotation_distance_reads_small_angles_without_a_floor():
    """The metric of phase 14 (a): the arccos metric's angle at moderate
    angles, and small angles exactly where the arccos of the trace reads
    its float floor or 0."""
    rng = np.random.default_rng(7)
    for deg in (1e-5, 1e-3, 0.5, 30.0, 120.0):
        axis = rng.normal(size=3)
        R_b = se3np.random_transform(rng)[:3, :3]
        R_a = se3np.exp_so3(np.radians(deg) * axis / np.linalg.norm(axis)) @ R_b
        got = se3np.rotation_distance_deg(R_a, R_b)
        np.testing.assert_allclose(got, deg, rtol=1e-6)
        if deg >= 0.5:
            np.testing.assert_allclose(got, se3np.rotation_angle_deg(R_a @ R_b.T), rtol=1e-6)
    assert se3np.rotation_distance_deg(R_b, R_b) == 0.0


def test_oracle_needs_no_torch():
    """The oracle's modules import NumPy and the port's params, nothing of
    torch (it is the CPU baseline)."""
    root = Path(toracle.__file__).parent
    for f in sorted(root.glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert not any(m.split(".")[0] == "torch" for m in mods), (f.name, mods)
