"""PyTorch port vs the JAX package: the SLAM front end (edge information,
the pose graph from registrations, landmark tracks, `run_sequence`) and the
SLAM-state checkpoint.

Both sides get the same NumPy inputs (`slam_sequence`, the JAX package's
`RegistrationResult` as NumPy); the JAX side runs as tests/test_slam.py
runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saccot_tpu.engine.sac_cot import register_batch as jregister_batch
from saccot_tpu.evaluation.metrics import ate as jate
from saccot_tpu.io.synthetic import correspondence_problem, slam_sequence
from saccot_tpu.slam import frontend as jfe
from saccot_tpu.utils import se3np
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch.engine.sac_cot import RegistrationResult
from saccot_tpu_torch.evaluation.metrics import ate
from saccot_tpu_torch.io.synthetic import slam_sequence as tslam_sequence
from saccot_tpu_torch.slam import frontend as tfe
from saccot_tpu_torch.utils import checkpoint
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

KW = dict(compat_tau=0.03, min_separation=0.08, inlier_tau=0.03, num_anchors=64,
          neighbors_per_anchor=10, max_hypotheses=256)


def _treg(reg) -> RegistrationResult:
    return RegistrationResult(*(torch.from_numpy(np.array(x)) for x in reg))


@pytest.fixture(scope="module")
def registered():
    """A 6-scan sequence (tests/test_slam.py's end-to-end size) and the JAX
    package's registration of its 7 edges, with 3 planted problems of
    mixed quality appended (one failed edge: all outliers)."""
    seq = slam_sequence(seed=13, n_scans=6, n_corr=192, outlier_ratio=0.4, noise=0.003,
                        loop_every=3)
    extra = [correspondence_problem(seed=60 + s, n=192, outlier_ratio=r, noise=nz)
             for s, (r, nz) in enumerate(((0.3, 0.008), (0.8, 0.002), (1.0, 0.002)))]
    P = np.concatenate([seq["edge_P"], np.stack([p["P"] for p in extra])])
    Q = np.concatenate([seq["edge_Q"], np.stack([p["Q"] for p in extra])])
    reg = jregister_batch(jnp.asarray(P), jnp.asarray(Q), JaxSacCotParams(**KW))
    return seq, P, Q, reg


def test_edge_information_matches_jax(registered):
    """[E, 6, 6] information from the inlier moments, rtol 1e-5, the
    all-outlier edge included."""
    _, P, Q, reg = registered
    ref = np.asarray(jfe.edge_information(reg, jnp.asarray(P), jnp.asarray(Q)))
    got = tfe.edge_information(_treg(reg), torch.from_numpy(P), torch.from_numpy(Q)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("use_points", [True, False])
def test_registrations_to_graph_matches_jax(registered, use_points):
    """The graph of the sequence's 7 edges: initial poses (odometry chain),
    measurements, weights and the adjoint-transported information, rtol
    1e-5."""
    seq, P, Q, reg = registered
    E = len(seq["edges"])
    sub = type(reg)(*(x[:E] for x in reg))
    pts = dict(edge_P=P[:E], edge_Q=Q[:E]) if use_points else {}
    ref = jfe.registrations_to_graph(6, jnp.asarray(seq["edges"]), sub, **pts)
    got = tfe.registrations_to_graph(6, torch.from_numpy(seq["edges"]), _treg(sub),
                                     **{k: torch.from_numpy(v) for k, v in pts.items()})
    for name in ("poses", "meas", "weight", "info"):
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(got.edge_i.numpy(), np.asarray(ref.edge_i))
    np.testing.assert_array_equal(got.edge_j.numpy(), np.asarray(ref.edge_j))


@pytest.mark.parametrize("mode", ["tracks", "pairwise"])
def test_correspondences_to_ba_matches_jax(registered, mode):
    """Host-side track association: equal arrays and equal stats, from the
    JAX package's inliers under ground-truth poses, also when the landmark
    budget truncates (max_landmarks 128, 3 slots a landmark)."""
    seq, P, Q, reg = registered
    E = len(seq["edges"])
    inl = np.asarray(reg.inliers)[:E]
    poses = seq["poses_gt"].astype(np.float32)
    for L, G in ((1024, 8), (128, 3)):
        args = (seq["edges"], P[:E], Q[:E], inl)
        kw = dict(max_landmarks=L, obs_per_landmark=G, merge_cell=0.09, mode=mode)
        ref, ref_stats = jfe.correspondences_to_ba(jnp.asarray(poses), *args, **kw)
        got, stats = tfe.correspondences_to_ba(torch.from_numpy(poses), *args, **kw)
        assert stats == ref_stats
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got.poses.device.type == "cpu"


def test_track_association_merges_covisible_points():
    """32 world points seen from 4 poses through 4 edges: 32 tracks, each
    multiview over all 4 poses (tests/test_slam.py), from an array of poses
    with an explicit device."""
    rng = np.random.default_rng(0)
    gt = [np.eye(4)]
    for _ in range(3):
        gt.append(gt[-1] @ se3np.random_transform(rng, 0.3, 0.4))
    gt = np.stack(gt)
    pts_w = rng.uniform(-1, 1, size=(32, 3))
    edges = np.array([(0, 1), (1, 2), (2, 3), (0, 3)], np.int32)
    eP = np.stack([se3np.apply_T(np.linalg.inv(gt[i]), pts_w) for i, _ in edges]).astype(np.float32)
    eQ = np.stack([se3np.apply_T(np.linalg.inv(gt[j]), pts_w) for _, j in edges]).astype(np.float32)
    prob, stats = tfe.correspondences_to_ba(gt.astype(np.float32), edges, eP, eQ,
                                            np.ones((4, 32), bool), max_landmarks=64,
                                            obs_per_landmark=8, merge_cell=0.05, device="cpu")
    assert stats["n_tracks_kept"] == 32 and stats["multiview_tracks"] == 32
    assert stats["max_track_obs"] == 8
    w, op = prob.obs_w[:32].numpy(), prob.obs_pose[:32].numpy()
    for k in range(32):
        assert set(op[k][w[k] > 0]) == {0, 1, 2, 3}


def test_run_sequence_matches_jax():
    """`run_sequence` at tests/test_slam.py's end-to-end size (6 scans, 7
    edges, N=192) on the CPU: the same edges registered with the same
    inlier counts, the same track stats, final poses within 1e-4 of the
    JAX package's, and both ATEs < 0.05."""
    seq = slam_sequence(seed=11, n_scans=6, n_corr=192, outlier_ratio=0.4, noise=0.003,
                        loop_every=3)
    kw = dict(n_scans=6, edges=seq["edges"], edge_P=seq["edge_P"], edge_Q=seq["edge_Q"],
              pgo_iters=8, run_ba=True, ba_iters=4, max_landmarks=512)
    ref = jfe.run_sequence(params=JaxSacCotParams(**KW), **kw)
    got = tfe.run_sequence(params=SacCotParams(**KW), device="cpu", **kw)
    np.testing.assert_array_equal(got.registration.success.numpy(),
                                  np.asarray(ref.registration.success))
    assert bool(got.registration.success.all())
    np.testing.assert_array_equal(got.registration.num_inliers.numpy(),
                                  np.asarray(ref.registration.num_inliers))
    assert got.num_failed_edges == ref.num_failed_edges == 0
    assert {k: v for k, v in got.ba_stats.items() if k != "huber_delta"} == \
        {k: v for k, v in ref.ba_stats.items() if k != "huber_delta"}
    np.testing.assert_allclose(got.ba_stats["huber_delta"], ref.ba_stats["huber_delta"],
                               rtol=1e-3)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    err = ate(got.poses.double().numpy(), seq["poses_gt"])
    err_ref = jate(np.asarray(ref.poses, np.float64), seq["poses_gt"])
    assert err["rmse"] < 0.05 and err_ref["rmse"] < 0.05, (err, err_ref)
    assert got.poses.device.type == "cpu"


def test_resume_matches_uninterrupted(tmp_path):
    """BA interrupted after 3 of 6 steps and resumed from its checkpoint
    (poses, landmarks, gn_iter, lam) ends on the uninterrupted run's bits;
    a rerun after the end restores the finished state."""
    seq = tslam_sequence(seed=9, n_scans=6, n_corr=192, outlier_ratio=0.4, noise=0.004,
                         loop_every=3, n_world=700)
    params = SacCotParams(**dict(KW, min_separation=0.05))
    kw = dict(n_scans=6, edges=seq["edges"], edge_P=seq["edge_P"], edge_Q=seq["edge_Q"],
              params=params, pgo_iters=6, max_landmarks=512, device="cpu")
    ref = tfe.run_sequence(ba_iters=6, **kw)
    ck = str(tmp_path / "slam_ck")
    part = tfe.run_sequence(ba_iters=3, ckpt_path=ck, ba_ckpt_every=3, **kw)
    res = tfe.run_sequence(ba_iters=6, ckpt_path=ck, ba_ckpt_every=3, **kw)
    assert torch.equal(res.poses, ref.poses)
    assert torch.equal(res.ba_result.final_cost, ref.ba_result.final_cost)
    assert torch.equal(res.ba_result.lam, ref.ba_result.lam)
    assert float(part.ba_result.final_cost) >= float(ref.ba_result.final_cost)
    assert int(checkpoint.restore(ck)["gn_iter"]) == 6
    done = tfe.run_sequence(ba_iters=6, ckpt_path=ck, ba_ckpt_every=3, **kw)
    assert torch.equal(done.poses, ref.poses)
    assert float(done.ba_result.final_cost) == float(done.ba_result.initial_cost)


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "state")
    assert checkpoint.restore(path) is None
    poses = torch.randn(5, 4, 4)
    lm = np.arange(12, dtype=np.float32).reshape(4, 3)
    checkpoint.save_slam_state(path, poses, lm, gn_iter=3, lam=0.25)
    st = checkpoint.restore(path)
    np.testing.assert_array_equal(st["poses"], poses.numpy())
    np.testing.assert_array_equal(st["landmarks"], lm)
    assert int(st["gn_iter"]) == 3 and float(st["lam"]) == 0.25
    checkpoint.save_slam_state(path, poses[:2], gn_iter=4)
    st = checkpoint.restore(path)
    assert st["poses"].shape == (2, 4, 4) and "landmarks" not in st
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["state"]


def test_propose_loop_candidates():
    M = 9
    ang = np.linspace(0, 2 * np.pi, M)
    poses = np.tile(np.eye(4), (M, 1, 1))
    poses[:, 0, 3] = np.cos(ang) * 2.0
    poses[:, 1, 3] = np.sin(ang) * 2.0
    cand = tfe.propose_loop_candidates(poses, min_gap=3, radius=0.5)
    np.testing.assert_array_equal(cand, jfe.propose_loop_candidates(poses, min_gap=3,
                                                                    radius=0.5))
    assert [0, M - 1] in cand.tolist() and all(j - i >= 3 for i, j in cand)


needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernels have no CPU mode")


@needs_cuda
def test_run_sequence_kernels_match_plain_on_card():
    """The slam configuration on the card: rows 1-4 (kernel route) against
    the plain route, both registering all 13 edges with the same track
    stats and final poses within 1e-3 and ATE < 0.05; a repeat call of the
    kernel route gives the same bits (no atomics in the solvers' sums)."""
    seq = tfe.slam_config_sequence()
    kw = dict(n_scans=tfe.SLAM_SCANS, edges=seq["edges"], edge_P=seq["edge_P"],
              edge_Q=seq["edge_Q"], params=tfe.SLAM_PARAMS, device="cuda")
    k = tfe.run_sequence(impl="kernel", **kw)
    p = tfe.run_sequence(impl="plain", **kw)
    assert bool(k.registration.success.all()) and bool(p.registration.success.all())
    assert {a: b for a, b in k.ba_stats.items() if a != "huber_delta"} == \
        {a: b for a, b in p.ba_stats.items() if a != "huber_delta"}
    assert (k.poses - p.poses).abs().max().item() < 1e-3
    for res in (k, p):
        assert ate(res.poses.double().cpu().numpy(), seq["poses_gt"])["rmse"] < tfe.SLAM_ATE_BOUND
    again = tfe.run_sequence(impl="kernel", **kw)
    assert torch.equal(again.poses, k.poses)
