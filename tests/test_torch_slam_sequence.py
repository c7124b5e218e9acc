"""PyTorch port vs the JAX package: `run_sequence` at the slam configuration
(`cli/configs.py` "slam", restated in `slam/frontend.py`) and at 128 scans,
on the CPU, with the configuration's runner arguments (the defaults).

Both sides get the same `slam_sequence` arrays; the JAX side runs as
tests/test_slam.py runs it. The cost of BA's initial iterate and of each
tried step is read from inside each side's loop (the JAX package's through
`jax.debug.callback`), so the two Levenberg-Marquardt schedules are held
step by step.
"""

import jax
import numpy as np
import pytest
import torch

import saccot_tpu.slam.ba as jba
from saccot_tpu.cli.configs import CONFIGS
from saccot_tpu.slam.frontend import run_sequence as jrun_sequence
from saccot_tpu_torch.evaluation.metrics import ate
from saccot_tpu_torch.slam import ba as tba
from saccot_tpu_torch.slam import frontend as fe

torch.set_num_threads(2)

# BA poses that the landmark tracks observe fewer times than this are held
# loosely: see test_slam_configuration_matches_jax.
WELL_OBSERVED = 10


def _ba_tries(mod, monkeypatch, jitted):
    """Record every cost `mod.bundle_adjust` computes: its initial iterate's
    and each tried step's."""
    costs = []
    orig = mod.ba_cost

    def rec(*a, **k):
        c = orig(*a, **k)
        if jitted:
            jax.debug.callback(lambda v: costs.append(float(v)), c, ordered=True)
        else:
            costs.append(float(c))
        return c

    monkeypatch.setattr(mod, "ba_cost", rec)
    return costs


def _decisions(costs):
    cur, out = costs[0], []
    for c in costs[1:]:
        out.append(c <= cur)
        cur = min(cur, c)
    return out


def _ba_obs_per_pose(seq, got):
    """Observations of each pose in the port's BA problem (the tracks that
    `run_sequence` built from its PGO poses and inliers)."""
    prob, _ = fe.correspondences_to_ba(
        got.pose_graph_result.poses, seq["edges"], seq["edge_P"], seq["edge_Q"],
        got.registration.inliers.numpy(), merge_cell=3.0 * fe.SLAM_PARAMS.inlier_tau,
        device="cpu")
    real = prob.obs_w > 0
    return torch.bincount(prob.obs_pose[real].long(), minlength=len(seq["poses_gt"])).numpy()


@pytest.mark.parametrize("n_scans", [fe.SLAM_SCANS, 128])
def test_slam_configuration_matches_jax(n_scans, monkeypatch):
    """The same edges registered with the same inlier counts and the same
    track stats; PGO poses within 1e-4 of the JAX package's; BA takes the
    same accept/reject decision at every step, its costs within 5e-5
    relative (the BA problems start from PGO poses a few 1e-6 apart), its
    landmarks within 1e-4.

    BA poses within 1e-4 wherever the tracks observe the pose at least
    WELL_OBSERVED times, or not at all. At 128 scans BA keeps 2,048 of about
    8,500 tracks and 13 poses are seen by 1-9 observations. The reduced
    camera system then has eigenvalues at the LM damping (1e-6, condition
    about 1e10) along those poses' unfixed directions. CG meets its 1e-6
    residual rule with the step's component there set by rounding: on the
    same BA problem the two packages' first steps differ by 2e-3 in those
    directions, and by 1e-5 elsewhere. Those poses are held within 2e-2 and
    the final cost within 5e-5."""
    seq = fe.slam_config_sequence(n_scans)
    kw = dict(n_scans=n_scans, edges=seq["edges"], edge_P=seq["edge_P"], edge_Q=seq["edge_Q"])
    jax.clear_caches()  # trace again, so the recorder is in the program
    jcosts = _ba_tries(jba, monkeypatch, jitted=True)
    try:
        ref = jrun_sequence(params=CONFIGS["slam"].params, **kw)
        ref_poses = np.asarray(ref.poses)
        jax.effects_barrier()
    finally:
        jax.clear_caches()  # no later caller meets the recorder
    tcosts = _ba_tries(tba, monkeypatch, jitted=False)
    got = fe.run_sequence(params=fe.SLAM_PARAMS, device="cpu", **kw)
    np.testing.assert_array_equal(got.registration.success.numpy(),
                                  np.asarray(ref.registration.success))
    assert bool(got.registration.success.all())
    np.testing.assert_array_equal(got.registration.num_inliers.numpy(),
                                  np.asarray(ref.registration.num_inliers))
    assert {k: v for k, v in got.ba_stats.items() if k != "huber_delta"} == \
        {k: v for k, v in ref.ba_stats.items() if k != "huber_delta"}
    np.testing.assert_allclose(got.pose_graph_result.poses.numpy(),
                               np.asarray(ref.pose_graph_result.poses), atol=1e-4)

    assert len(jcosts) == len(tcosts) == 6, (jcosts, tcosts)  # initial + 5 steps
    assert _decisions(jcosts) == _decisions(tcosts), (jcosts, tcosts)
    np.testing.assert_allclose(tcosts, jcosts, rtol=5e-5)
    np.testing.assert_allclose(got.ba_result.landmarks.numpy(),
                               np.asarray(ref.ba_result.landmarks), atol=1e-4)
    obs = _ba_obs_per_pose(seq, got)
    firm = (obs == 0) | (obs >= WELL_OBSERVED)
    np.testing.assert_allclose(got.poses.numpy()[firm], ref_poses[firm], atol=1e-4)
    np.testing.assert_allclose(got.poses.numpy()[~firm], ref_poses[~firm], atol=2e-2)
    if n_scans == fe.SLAM_SCANS:
        assert firm.all()
    else:
        assert 0 < (~firm).sum() <= 16, obs

    gt = seq["poses_gt"]
    got_ate = ate(got.poses.double().numpy(), gt)["rmse"]
    ref_ate = ate(ref_poses.astype(np.float64), gt)["rmse"]
    if n_scans == fe.SLAM_SCANS:
        assert got_ate < fe.SLAM_ATE_BOUND and ref_ate < fe.SLAM_ATE_BOUND
    np.testing.assert_allclose(got_ate, ref_ate, rtol=0.05)
