"""PyTorch port vs the JAX package: the whole estimator (`register_batch`).

The JAX side runs with all four stages on their Pallas kernels, in interpret
mode on the CPU, as tests/test_kernels.py runs them; both sides get the same
NumPy inputs. The oracle checks mirror tests/test_engine.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from saccot_tpu.engine.sac_cot import register_batch as jregister_batch
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.oracle import saccot as oracle
from saccot_tpu.utils import se3np
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch import SacCotParams, register_batch, register_pair
from saccot_tpu_torch.utils.convert import problem_batch, recall, result_to_numpy, to_torch

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
EXACT = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
)
FAST = dataclasses.replace(EXACT, dedup_triangles=False, approx_topk=True,
                           per_anchor_candidates=4)


@pytest.fixture(scope="module")
def batch():
    return problem_batch(range(1000, 1003), device="cpu", n=300, outlier_ratio=0.8, noise=0.004)


@pytest.mark.parametrize("config", ["exact", "fast"])
def test_register_batch_matches_jax(batch, config):
    params = EXACT if config == "exact" else FAST
    P, Q, T_gt = batch
    got = result_to_numpy(register_batch(P, Q, params))
    ref = jregister_batch(jnp.asarray(P.numpy()), jnp.asarray(Q.numpy()),
                          JaxSacCotParams(**dataclasses.asdict(params)),
                          compat_impl="pallas", score_impl="pallas", pool_impl="pallas",
                          solve_impl="pallas")
    for b in range(3):
        E = got.T[b].astype(np.float64) @ np.linalg.inv(np.asarray(ref.T[b], np.float64))
        assert se3np.rotation_angle_deg(E[:3, :3]) < 0.1
        assert np.linalg.norm(E[:3, 3]) < 1e-3
    np.testing.assert_array_equal(got.num_inliers, np.asarray(ref.num_inliers))
    np.testing.assert_array_equal(got.success, np.asarray(ref.success))
    np.testing.assert_array_equal(got.num_valid_triangles, np.asarray(ref.num_valid_triangles))
    assert recall(register_batch(P, Q, params), T_gt, 5.0, 0.05) == 1.0


@pytest.mark.parametrize("config", ["exact", "fast"])
def test_register_batch_weighted_matches_jax(batch, config):
    """`scoring="weighted"` end to end against the JAX package, under the
    count test's bounds: the weights are summed in another order on each
    side, so a near-tie in the argmax could pick another hypothesis."""
    params = dataclasses.replace(EXACT if config == "exact" else FAST, scoring="weighted")
    P, Q, T_gt = batch
    got = result_to_numpy(register_batch(P, Q, params))
    ref = jregister_batch(jnp.asarray(P.numpy()), jnp.asarray(Q.numpy()),
                          JaxSacCotParams(**dataclasses.asdict(params)),
                          compat_impl="pallas", score_impl="pallas", pool_impl="pallas",
                          solve_impl="pallas")
    for b in range(3):
        E = got.T[b].astype(np.float64) @ np.linalg.inv(np.asarray(ref.T[b], np.float64))
        assert se3np.rotation_angle_deg(E[:3, :3]) < 0.1
        assert np.linalg.norm(E[:3, 3]) < 1e-3
    np.testing.assert_array_equal(got.num_inliers, np.asarray(ref.num_inliers))
    np.testing.assert_array_equal(got.success, np.asarray(ref.success))
    np.testing.assert_array_equal(got.num_valid_triangles, np.asarray(ref.num_valid_triangles))
    assert recall(register_batch(P, Q, params), T_gt, 5.0, 0.05) == 1.0


def test_register_matches_oracle_exhaustive():
    """Exhaustive regime (A >= N, B >= N-1): the pool is a superset of the
    oracle's clique enumeration, so the registrations agree."""
    n = 96
    params = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
                          num_anchors=n, neighbors_per_anchor=n - 1, max_hypotheses=512)
    prob = correspondence_problem(seed=11, n=n, outlier_ratio=0.5, noise=0.004)
    want = oracle.sac_cot(prob["P"], prob["Q"], JaxSacCotParams(**dataclasses.asdict(params)))
    P, Q = to_torch(prob["P"], prob["Q"], device="cpu")
    got = result_to_numpy(register_pair(P, Q, params))
    assert bool(got.success)
    E = got.T.astype(np.float64) @ np.linalg.inv(want["T"])
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.1
    assert np.linalg.norm(E[:3, 3]) < 1e-3
    assert abs(int(got.num_inliers) - want["num_inliers"]) <= 1
    E2 = got.T.astype(np.float64) @ np.linalg.inv(prob["T_gt"])
    assert se3np.rotation_angle_deg(E2[:3, :3]) < 2.0


def test_register_pair_is_a_batch_of_one(batch):
    P, Q, _ = batch
    one = register_pair(P[1], Q[1], EXACT)
    many = register_batch(P, Q, EXACT)
    for a, b in zip(one, many):
        assert torch.equal(a, b[1])


def test_mask_and_failure_flag():
    prob = correspondence_problem(seed=11, n=96, outlier_ratio=0.5, noise=0.004)
    P, Q = to_torch(prob["P"], prob["Q"], device="cpu")
    mask = torch.ones(96)
    mask[48:] = 0
    res = register_pair(P, Q, EXACT, mask=mask)
    assert not res.inliers[48:].any()
    # No compatible pair anywhere: identity, no inliers, no success.
    rng = np.random.default_rng(8)
    P = rng.uniform(-1, 1, size=(32, 3)).astype(np.float32)
    Q = (rng.uniform(10, 20, size=(32, 3)) * np.array([1, 3, 7.0])).astype(np.float32)
    params = SacCotParams(compat_tau=1e-6, min_separation=0.01, inlier_tau=0.01,
                          num_anchors=32, neighbors_per_anchor=8, max_hypotheses=64)
    res = register_pair(*to_torch(P, Q, device="cpu"), params)
    assert not bool(res.success) and int(res.num_inliers) == 0
    assert int(res.num_valid_triangles) == 0
    np.testing.assert_array_equal(res.R.numpy(), np.eye(3))


@needs_cuda
@pytest.mark.parametrize("config", ["exact", "fast"])
def test_register_batch_kernels_match_plain_on_card(batch, config):
    params = EXACT if config == "exact" else FAST
    P, Q, T_gt = batch
    P, Q = P.cuda(), Q.cuda()
    got = register_batch(P, Q, params)
    ref = register_batch(P, Q, params, impl="plain")
    assert recall(got, T_gt, 5.0, 0.05) == recall(ref, T_gt, 5.0, 0.05) == 1.0
    assert (got.num_inliers - ref.num_inliers).abs().max() <= 1


@needs_cuda
@pytest.mark.parametrize("config", ["exact", "fast"])
def test_register_batch_weighted_kernels_match_plain_on_card(batch, config):
    """`scoring="weighted"` through the kernels and the plain versions: the
    same registration (recall, inliers within 1), and on the kernel route's
    pool the score kernel picks the plain version's hypothesis in every pair,
    or one whose plain score lies within 2 rtol of it (each side is within
    `weighted_rtol(N)` of the plain score)."""
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import score as kscore
    from saccot_tpu_torch.kernels import solve3 as ksolve

    params = dataclasses.replace(EXACT if config == "exact" else FAST, scoring="weighted")
    P, Q, T_gt = batch
    P, Q = P.cuda(), Q.cuda()
    got = register_batch(P, Q, params)
    ref = register_batch(P, Q, params, impl="plain")
    assert recall(got, T_gt, 5.0, 0.05) == recall(ref, T_gt, 5.0, 0.05) == 1.0
    assert (got.num_inliers - ref.num_inliers).abs().max() <= 1
    pool = tri_mod.triangle_pool_from_points(P, Q, kcompat.degrees(P, Q, P, Q, params), params)
    args = (*ksolve.solve3(P, Q, pool.triples), P, Q, params.inlier_tau)
    sk = torch.where(pool.valid, kscore.score_hypotheses(*args, mode="weighted")[0], -1.0)
    sp = torch.where(pool.valid, kscore.score_hypotheses_reference(*args, mode="weighted")[0],
                     -1.0)
    pk, pp = sk.argmax(dim=1), sp.argmax(dim=1)
    rows = torch.arange(P.shape[0], device=P.device)
    margin = (sp[rows, pp] - sp[rows, pk]) / sp[rows, pp]
    assert (margin <= 2 * kscore.weighted_rtol(P.shape[1])).all(), margin
