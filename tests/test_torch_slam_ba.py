"""PyTorch port vs the JAX package: Schur-complement bundle adjustment.

Both sides get the problems of tests/test_slam.py (`_make_ba_problem`, the
same NumPy draws); the JAX side runs jitted, as tests/test_slam.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_slam as jts
from saccot_tpu.slam import ba as jba
from saccot_tpu_torch.slam import ba as tba
from saccot_tpu_torch.slam import sparse

torch.set_num_threads(2)


def _tprob(prob) -> tba.BAProblem:
    return tba.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


@pytest.mark.parametrize("seed,robust_delta", [(3, None), (5, None), (6, 0.02)])
def test_bundle_adjust_matches_jax(seed, robust_delta):
    """bundle_adjust (M=6, L=64, G=4, 8 steps) against the JAX package:
    poses and landmarks within 2e-4, final cost within 1e-4 relative. The
    LM schedule may differ at float-level ties after convergence (seed 5:
    the JAX package rejects a step the port takes), which moves neither
    beyond the tolerance."""
    prob, gt_poses, _ = jts._make_ba_problem(seed=seed)
    ref = jax.jit(jba.bundle_adjust, static_argnames=("iters",))(
        prob, iters=8, robust_delta=robust_delta)
    got = tba.bundle_adjust(_tprob(prob), iters=8, robust_delta=robust_delta)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=2e-4)
    np.testing.assert_allclose(got.landmarks.numpy(), np.asarray(ref.landmarks), atol=2e-4)
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost), rtol=1e-4)
    assert float(got.final_cost) < 0.2 * float(got.initial_cost)


def test_gn_system_matches_jax():
    """One step's reduced camera system, block by block (Hpp, the reduced
    gradient, the fill-in diagonal, Hll^-1, b_l, W) and the Schur matvec,
    against the JAX package's, with a Huber gate."""
    prob, _, _ = jts._make_ba_problem(seed=7)
    M = prob.poses.shape[0]
    ref = jax.jit(jba._gn_system, static_argnums=(3,))(
        prob.poses, prob.landmarks, prob, M, 1e-6, 0.02)
    tp = _tprob(prob)
    slots = sparse.segments(tp.obs_pose, M, keep=tp.obs_w != 0)
    got = tba._gn_system(tp.poses, tp.landmarks, tp, M, 1e-6, 0.02, slots)
    for name, a, b in zip(("Hpp", "b_red", "Fdiag", "Hll_inv", "bl", "W"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4, err_msg=name)
    x = np.random.default_rng(0).normal(size=(M, 6)).astype(np.float32)
    free = (np.arange(M) >= 1).astype(np.float32)[:, None]
    y_ref = jba._schur_matvec(jnp.asarray(x), ref[0], ref[3], ref[5], prob.obs_pose, 0.1,
                              jnp.asarray(free), None)
    y = tba._schur_matvec(torch.from_numpy(x), got[0], got[3], got[5], tp.obs_pose.long(), 0.1,
                          torch.from_numpy(free), slots)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-4)
    for delta in (None, 0.02):
        np.testing.assert_allclose(
            float(tba.ba_cost(tp.poses, tp.landmarks, tp, robust_delta=delta)),
            float(jba.ba_cost(prob.poses, prob.landmarks, prob, robust_delta=delta)), rtol=1e-5)


def test_ba_reduces_cost_and_recovers_poses():
    """tests/test_slam.py's checks on the port: cost below 5% of the start
    and ATE < 0.05; exact observations reach cost < 1e-6."""
    prob, gt_poses, _ = jts._make_ba_problem(seed=3)
    res = tba.bundle_adjust(_tprob(prob), iters=8)
    assert float(res.final_cost) < float(res.initial_cost) * 0.05
    assert jts.ate_rmse(res.poses.double().numpy(), gt_poses) < 0.05
    prob, _, _ = jts._make_ba_problem(seed=4, noise=0.0, init_noise=0.02)
    assert float(tba.bundle_adjust(_tprob(prob), iters=8).final_cost) < 1e-6


def test_ba_scales_to_hundreds_of_poses():
    """The matrix-free PCG path at M=128, L=4096, G=4, 6 steps, 96 CG steps
    (tests/test_slam.py's scale point): cost below 20% of the start, ATE
    < 0.05."""
    prob, gt_poses, _ = jts._make_ba_problem(seed=8, M=128, L=4096, G=4, noise=0.005,
                                             init_noise=0.03)
    res = tba.bundle_adjust(_tprob(prob), iters=6, cg_iters=96)
    assert float(res.final_cost) < float(res.initial_cost) * 0.2
    assert jts.ate_rmse(res.poses.double().numpy(), gt_poses) < 0.05


def test_ba_resume_with_lam0_is_the_same_solve():
    """Three steps, then three more from the first call's iterate and
    `lam`, give the bits of six steps in one call; a repeat call gives the
    same bits."""
    prob, _, _ = jts._make_ba_problem(seed=5)
    tp = _tprob(prob)
    full = tba.bundle_adjust(tp, iters=6)
    half = tba.bundle_adjust(tp, iters=3)
    rest = tba.bundle_adjust(tp._replace(poses=half.poses, landmarks=half.landmarks), iters=3,
                             lam0=half.lam)
    for a, b in ((rest.poses, full.poses), (rest.landmarks, full.landmarks),
                 (rest.final_cost, full.final_cost), (rest.lam, full.lam)):
        assert torch.equal(a, b)
    again = tba.bundle_adjust(tp, iters=6)
    assert torch.equal(again.poses, full.poses) and torch.equal(again.lam, full.lam)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_bundle_adjust_on_card_repeats_and_matches_cpu():
    """BA at the tests' scale point on the card: a repeat call gives the
    same bits (padded segment rows, no atomics), and the poses are within
    1e-4 of the CPU solve."""
    prob, gt_poses, _ = jts._make_ba_problem(seed=8, M=128, L=4096, G=4, noise=0.005,
                                             init_noise=0.03)
    cpu = tba.bundle_adjust(_tprob(prob), iters=6, cg_iters=96)
    card = tba.BAProblem(*(x.cuda() for x in _tprob(prob)))
    a = tba.bundle_adjust(card, iters=6, cg_iters=96)
    b = tba.bundle_adjust(card, iters=6, cg_iters=96)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.landmarks, b.landmarks)
    np.testing.assert_allclose(a.poses.cpu().numpy(), cpu.poses.numpy(), atol=1e-4)
    assert jts.ate_rmse(a.poses.double().cpu().numpy(), gt_poses) < 0.05
