"""PyTorch port vs the JAX package: the whole cloud-to-transform pipeline
(`register_clouds`, its Harris + FPFH variant, `register_clouds_batch`, the
scan-feature entry points and the ICP polish).

The JAX side runs the body of its jitted entry points op by op
(`_register_clouds`, `register_scan_features.__wrapped__`), as its stage
tests run the stages: a jitted program contracts multiply-adds across fused
operations, which moves its own keypoint counts (246 against 250 on the
seed-9 source view at 2,048 points), so it is no fixed reference for a
count. Views of 1,024 points (2,048 on the card). The port runs on CPU tensors (`device="cpu"`): the kernel wrappers
take their plain versions there. Both get the same NumPy clouds.

Held: the same `success`, T within 0.1 degrees and 1e-3 of the JAX
package's, and keypoint and correspondence counts within 2. The counts are
not always equal: the closed-form eigensolver runs through `acos` and
`cos`, which XLA and torch round differently on the CPU, so a point whose
ISS saliency or Harris response lies within an ulp-sized band of a
neighbour's can flip its NMS decision (tests/test_torch_features.py holds
each detector to one flip per cloud). Over seeds 9-14 at 1,024 and 2,048
points a view, ISS + SHOT and Harris + FPFH, the counts differed by at
most 2 keypoints and 1 correspondence, T by at most 0.045 degrees.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from saccot_tpu.engine.icp import IcpParams as JIcpParams
from saccot_tpu.features import pipeline as jpipe
from saccot_tpu.io.synthetic import two_view_pair
from saccot_tpu.utils import se3np
from saccot_tpu.utils.params import SacCotParams as JSacCotParams
from saccot_tpu_torch.engine.icp import IcpParams
from saccot_tpu_torch.features import pipeline
from saccot_tpu_torch.utils import profile
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the estimator kernels have no CPU mode")

PIPE = dict(normal_k=16, iss_salient_mult=5.0, iss_nms_mult=3.0, max_keypoints=256,
            descriptor="shot", descriptor_radius_mult=10.0, descriptor_k=48,
            max_correspondences=256, compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0)
EST = dict(num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256)
HARRIS = dict(PIPE, keypoints="harris", descriptor="fpfh")
ICP = dict(max_iters=10, max_corr_dist=6.0, trim_frac=0.8)


def configs(pipe, icp=None):
    """(the port's PipelineConfig, the JAX package's) for the same fields."""
    t = pipeline.PipelineConfig(**pipe, estimator=SacCotParams(**EST),
                                icp=None if icp is None else IcpParams(**icp))
    j = jpipe.PipelineConfig(**pipe, estimator=JSacCotParams(**EST),
                             icp=None if icp is None else JIcpParams(**icp))
    return t, j


def rot_trans_err(T_a, T_b):
    E = np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64))
    return se3np.rotation_angle_deg(E[:3, :3]), np.linalg.norm(E[:3, 3])


def hold(got, want, T_gt=None):
    """Counts within 2 and the same success, T within 0.1 deg and 1e-3 of
    JAX's; registered under 5 deg / 0.05 where T_gt is given."""
    for name in ("num_keypoints_src", "num_keypoints_tgt", "num_correspondences"):
        assert abs(int(getattr(got, name)) - int(getattr(want, name))) <= 2, name
    assert bool(got.registration.success) == bool(want.registration.success)
    rot, trans = rot_trans_err(got.registration.T.numpy(), want.registration.T)
    assert rot < 0.1 and trans < 1e-3, (rot, trans)
    assert abs(float(got.resolution) - float(want.resolution)) <= 1e-6 * float(want.resolution)
    if T_gt is not None:
        rot, trans = rot_trans_err(got.registration.T.numpy(), T_gt)
        assert rot < 5.0 and trans < 0.05, (rot, trans)


@pytest.fixture(scope="module")
def pair9():
    return two_view_pair(seed=9, n_points=1024, overlap=0.8, noise=0.002)


def _jax_register(pair, jcfg):
    return jpipe._register_clouds(jnp.asarray(pair["source"]), jnp.asarray(pair["target"]),
                                  jcfg, None, None)


def test_register_clouds_matches_jax(pair9):
    """ISS + SHOT (soft binning), the default pipeline."""
    tcfg, jcfg = configs(PIPE)
    got = pipeline.register_clouds(pair9["source"], pair9["target"], tcfg, device="cpu")
    hold(got, _jax_register(pair9, jcfg), pair9["T_gt"])
    assert got.registration.T.shape == (4, 4) and got.corr_P.shape == (256, 3)
    assert int(got.num_correspondences) > 30


def test_register_clouds_harris_fpfh_matches_jax():
    pair = two_view_pair(seed=21, n_points=1024, overlap=0.85, noise=0.002)
    tcfg, jcfg = configs(HARRIS)
    got = pipeline.register_clouds(pair["source"], pair["target"], tcfg, device="cpu")
    hold(got, _jax_register(pair, jcfg))
    rot, _ = rot_trans_err(got.registration.T.numpy(), pair["T_gt"])
    assert rot < 5.0


def test_register_clouds_batch_matches_jax():
    """Two pairs in one call: each pair as the JAX package's pipeline runs
    it (its `register_clouds_batch` is a vmap of that function), and as
    the port's `register_clouds` runs it alone."""
    src, tgt, T_gt = pipeline.bunny_pairs([30, 31], device="cpu", n_points=1024)
    tcfg, jcfg = configs(PIPE)
    got = pipeline.register_clouds_batch(src, tgt, tcfg, device="cpu")
    assert got.registration.T.shape == (2, 4, 4) and got.num_correspondences.shape == (2,)
    for b in range(2):
        one = pipeline.register_clouds(src[b], tgt[b], tcfg, device="cpu")
        want = jpipe._register_clouds(jnp.asarray(src[b].numpy()), jnp.asarray(tgt[b].numpy()),
                                      jcfg, None, None)
        pick = lambda r: pipeline.PipelineResult(*(
            type(x)(*(y[b] for y in x)) if isinstance(x, tuple) else x[b] for x in r))
        hold(pick(got), want, T_gt[b])
        np.testing.assert_array_equal(pick(got).registration.T.numpy(), one.registration.T.numpy())


def test_scan_features_match_jax(pair9):
    """`extract_scan_features` + `register_scan_features`: the resolution
    within 1e-6 relative; the descriptors of the keypoints both sides hold
    within 1e-5 for 99% of them and 1e-3 for all (a SHOT frame whose two
    eigenvalues nearly tie turns by the eigensolver's ulps, and soft bins
    follow it); the pair's counts and T as `hold` says; `corr_P`/`corr_Q`
    are the matched sets in metric units, masked by the inliers."""
    tcfg, jcfg = configs(PIPE)
    fs = [pipeline.extract_scan_features(pair9[v], tcfg, device="cpu") for v in ("source", "target")]
    jfs = [jpipe.extract_scan_features.__wrapped__(jnp.asarray(pair9[v]), jcfg)
           for v in ("source", "target")]
    for f, jf in zip(fs, jfs):
        assert abs(float(f.resolution) - float(jf.resolution)) <= 1e-6 * float(jf.resolution)
        rows = {tuple(x): d for x, d, v in zip(np.asarray(jf.kp_xyz), np.asarray(jf.desc),
                                                np.asarray(jf.kp_valid)) if v}
        both = [(d, rows[tuple(x)]) for x, d, v in zip(f.kp_xyz.numpy(), f.desc.numpy(),
                                                         f.kp_valid.numpy()) if v and tuple(x) in rows]
        assert len(both) >= len(rows) - 2
        err = np.array([np.abs(a - b).max() for a, b in both])
        assert (err < 1e-3).all() and (err < 1e-5).mean() >= 0.99, np.sort(err)[-5:]
    got = pipeline.register_scan_features(*fs, tcfg)
    want = jpipe.register_scan_features.__wrapped__(*jfs, jcfg)
    hold(got, want, pair9["T_gt"])
    assert got.corr_P.shape == got.corr_Q.shape == (256, 3)
    inl = got.registration.inliers.numpy()
    R, t = got.registration.R.numpy(), got.registration.t.numpy()
    resid = np.linalg.norm(got.corr_P.numpy()[inl] @ R.T + t - got.corr_Q.numpy()[inl], axis=-1)
    assert inl.sum() > 20 and (resid < 3.0 * float(got.resolution) * 1.001).all()


def test_icp_polish_matches_jax(pair9):
    """cfg.icp (trimmed point-to-point) after the estimator, as
    tests/test_features.py runs it: JAX's counts and success, T within
    0.1 deg and 1e-3, at least as close to the truth as the coarse T."""
    tcfg, jcfg = configs(PIPE, ICP)
    got = pipeline.register_clouds(pair9["source"], pair9["target"], tcfg, device="cpu")
    want = _jax_register(pair9, jcfg)
    hold(got, want, pair9["T_gt"])
    assert float(got.icp_rmse) > 0.0
    assert abs(float(got.icp_rmse) - float(want.icp_rmse)) < 0.02 * float(want.icp_rmse)
    coarse = pipeline.register_clouds(pair9["source"], pair9["target"],
                                      dataclasses.replace(tcfg, icp=None), device="cpu")
    rot_f, _ = rot_trans_err(got.registration.T.numpy(), pair9["T_gt"])
    rot_c, _ = rot_trans_err(coarse.registration.T.numpy(), pair9["T_gt"])
    assert rot_f <= rot_c * 1.2 + 0.1
    assert float(coarse.icp_rmse) == 0.0


def test_voxel_grid_and_masked_icp_match_jax():
    """`voxel_mult` > 0: both clouds go through the voxel grid (a 1,024
    budget), the features and ICP then run on masked clouds."""
    pair = two_view_pair(seed=9, n_points=1024, overlap=0.8, noise=0.002)
    tcfg, jcfg = configs(dict(PIPE, voxel_mult=1.5, max_cloud_points=512), ICP)
    got = pipeline.register_clouds(pair["source"], pair["target"], tcfg, device="cpu")
    want = _jax_register(pair, jcfg)
    hold(got, want, pair["T_gt"])
    assert abs(float(got.icp_rmse) - float(want.icp_rmse)) < 0.02 * float(want.icp_rmse)


def test_stage_ranges_and_corr_mask():
    """Each stage of `register_clouds_batch` runs inside its profiler range,
    as `utils.profile.range_ms` reads them: per pair one resolution and one
    matching, per cloud one knn_normals, keypoints and descriptors, per
    batch one estimator and one ICP. `corr_mask` marks the first
    `num_correspondences` rows of `corr_P` / `corr_Q`."""
    src, tgt, _ = pipeline.bunny_pairs([30, 31], device="cpu", n_points=512)
    tcfg, _ = configs(PIPE, ICP)
    out = []
    rows = profile.profiler_rows(
        lambda: out.append(pipeline.register_clouds_batch(src, tgt, tcfg, device="cpu")), 1)
    got = profile.range_ms(rows, pipeline.STAGE_PREFIX, 1)
    assert {k: v["calls"] for k, v in got.items()} == dict(
        resolution=2, knn_normals=4, keypoints=4, descriptors=4, matching=2, estimator=1, icp=1)
    assert all(v["host_ms"] > 0.0 for v in got.values())
    res = out[0]
    rows_of = torch.arange(res.corr_mask.shape[1])[None]
    assert torch.equal(res.corr_mask, (rows_of < res.num_correspondences[:, None]).float())
    assert (res.num_correspondences > 20).all()


def test_config_checks():
    for bad in (dict(descriptor="fcgf"), dict(keypoints="sift"), dict(impl="pallas")):
        with pytest.raises(ValueError):
            pipeline.PipelineConfig(**bad)


@needs_cuda
def test_pipeline_on_card_repeats_bits_and_ignores_tf32():
    """Two bunny-shaped pairs (2,048 points) on the card: a repeat call,
    and a call with TF32 allowed for matmuls, give the same bits; the plain
    estimator route picks the same correspondences (the feature stages are
    shared) and a transform within 0.1 deg."""
    src, tgt, T_gt = pipeline.bunny_pairs([9, 10], device="cuda", n_points=2048)
    tcfg, _ = configs(PIPE)
    first = pipeline.register_clouds_batch(src, tgt, tcfg)
    again = pipeline.register_clouds_batch(src, tgt, tcfg)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = pipeline.register_clouds_batch(src, tgt, tcfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for other in (again, tf32):
        assert torch.equal(first.registration.T, other.registration.T)
        assert torch.equal(first.num_correspondences, other.num_correspondences)
    plain = pipeline.register_clouds_batch(src, tgt, dataclasses.replace(tcfg, impl="plain"))
    assert torch.equal(first.num_correspondences, plain.num_correspondences)
    for b in range(2):
        rot, _ = rot_trans_err(first.registration.T[b].cpu().numpy(),
                               plain.registration.T[b].cpu().numpy())
        assert rot < 0.1


@needs_cuda
def test_features_on_card_match_cpu():
    """Descriptors on the card within 1e-5 of the CPU run's (the same
    operations; the card's own transcendental functions)."""
    src, _, _ = pipeline.bunny_pairs([9], device="cpu", n_points=2048)
    tcfg, _ = configs(PIPE)
    pr = pipeline.cloud_resolution(src[0], tcfg)
    kp_c, d_c = pipeline.extract_features(src[0], tcfg, pr)
    kp_g, d_g = pipeline.extract_features(src[0].cuda(), tcfg, pr.cuda())
    common = np.intersect1d(kp_c.idx.numpy(), kp_g.idx.cpu().numpy())
    assert len(common) >= 0.95 * int(kp_c.valid.sum())
    rows_c = {int(i): r for i, r in zip(kp_c.idx.numpy(), d_c.numpy())}
    rows_g = {int(i): r for i, r in zip(kp_g.idx.cpu().numpy(), d_g.cpu().numpy())}
    np.testing.assert_allclose(np.stack([rows_g[i] for i in common]),
                               np.stack([rows_c[i] for i in common]), atol=1e-5)
