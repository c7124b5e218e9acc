"""PyTorch port vs the JAX package: descriptor matching, `.npz` descriptor
ingestion, SE(3) algebra and ICP.

The same NumPy inputs on both sides; the JAX functions run op by op, as
tests/test_features.py and tests/test_icp.py run them; the port on CPU
tensors. Tolerances are stated at each test.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from saccot_tpu.features.normals import estimate_normals as jestimate_normals
from saccot_tpu.io import external as jexternal
from saccot_tpu.io.synthetic import blob_cloud, correspondence_problem
from saccot_tpu.match import topk as jtopk
from saccot_tpu.slam import se3 as jse3
from saccot_tpu.utils import se3np
from saccot_tpu_torch.engine import icp
from saccot_tpu_torch.io import external
from saccot_tpu_torch.match import topk
from saccot_tpu_torch.slam import se3

jicp = importlib.import_module("saccot_tpu.engine.icp")   # engine/__init__ exports a function `icp`

torch.set_num_threads(2)


def T(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _descriptors(seed, ns=200, nt=180, dim=32):
    """Target rows near some source rows (true matches) among random ones."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(ns, dim)).astype(np.float32)
    tgt = rng.normal(size=(nt, dim)).astype(np.float32)
    tgt[:120] = src[rng.permutation(ns)[:120]] + 0.1 * rng.normal(size=(120, dim))
    return src, tgt, rng.random(ns) < 0.9, rng.random(nt) < 0.9


def _hold_filtered(got, want):
    """`mutual_filter` outputs: the same valid count, +inf padding, the
    same (source, target) pairs, each in the same slot unless it moved only
    among distances within the Gram form's 2e-5 (squared) of its own."""
    v, jv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(v, jv)
    assert np.isinf(got.distance.numpy()[~v]).all() and np.isinf(np.asarray(want.distance)[~v]).all()
    pairs = list(zip(got.src_idx.numpy()[v], got.tgt_idx.numpy()[v]))
    jpairs = list(zip(np.asarray(want.src_idx)[v], np.asarray(want.tgt_idx)[v]))
    assert sorted(pairs) == sorted(jpairs)
    jd2 = np.asarray(want.distance)[v].astype(np.float64) ** 2
    slot = {p: i for i, p in enumerate(jpairs)}
    for i, p in enumerate(pairs):
        assert abs(jd2[slot[p]] - jd2[i]) <= 2e-5, (i, slot[p], jd2[slot[p]], jd2[i])
    np.testing.assert_allclose(got.distance.numpy()[v] ** 2, jd2[[slot[p] for p in pairs]],
                               atol=2e-5)


@pytest.mark.parametrize("variant", ["mutual", "plain", "ratio", "masked"])
def test_match_and_mutual_filter_match_jax(variant):
    """Indices and validity equal; squared distances within 2e-5 (the Gram
    product sums 32 terms in another order, and |a|^2 + |b|^2 - 2 a.b
    cancels: the norms here are near 32, whose ulp is 3.8e-6);
    `mutual_filter`'s order, its +inf padding and validity equal."""
    src, tgt, ms, mt = _descriptors(3)
    kw = dict(mutual=variant != "plain", ratio_test=0.9 if variant == "ratio" else 0.0)
    jm = jtopk.match_descriptors(jnp.asarray(src), jnp.asarray(tgt),
                                 mask_src=jnp.asarray(ms) if variant == "masked" else None,
                                 mask_tgt=jnp.asarray(mt) if variant == "masked" else None, **kw)
    tm = topk.match_descriptors(T(src), T(tgt), mask_src=T(ms) if variant == "masked" else None,
                                mask_tgt=T(mt) if variant == "masked" else None, **kw)
    for name in ("src_idx", "tgt_idx", "valid"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    close_d2 = lambda g, w: np.testing.assert_allclose(g ** 2, w ** 2, atol=2e-5)
    close_d2(tm.distance.numpy(), np.asarray(jm.distance))
    assert 0 < tm.valid.sum() <= len(src)
    for cap in (64, 500):
        jf, tf = jtopk.mutual_filter(jm, cap), topk.mutual_filter(tm, cap)
        _hold_filtered(tf, jf)
    P, Q, m = topk.gather_correspondences(T(src[:, :3]), T(tgt[:, :3]), tf)
    jP, jQ, jmask = jtopk.gather_correspondences(jnp.asarray(src[:, :3]), jnp.asarray(tgt[:, :3]), jf)
    np.testing.assert_array_equal(P.numpy(), np.asarray(jP))
    np.testing.assert_array_equal(Q.numpy(), np.asarray(jQ))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))


def test_match_ties_go_to_the_lowest_index():
    """Duplicate target rows tie exactly: the lowest index wins, as in
    `lax.top_k` and `argmin`; so does the filter among equal distances."""
    src = np.eye(4, 8, dtype=np.float32)
    tgt = np.concatenate([src, src])            # rows i and i + 4 tie
    m = topk.match_descriptors(T(src), T(tgt), mutual=False)
    np.testing.assert_array_equal(m.tgt_idx.numpy(), np.arange(4))
    jm = jtopk.match_descriptors(jnp.asarray(src), jnp.asarray(tgt), mutual=False)
    np.testing.assert_array_equal(np.asarray(jm.tgt_idx), np.arange(4))
    f = topk.mutual_filter(m, 3)
    np.testing.assert_array_equal(f.src_idx.numpy(), np.asarray(jtopk.mutual_filter(jm, 3).src_idx))


def test_external_descriptors_match_jax(tmp_path):
    """The `.npz` round trip, and `correspondences_from_descriptors`: the
    mask equal to the JAX package's, the same (P, Q) rows, each in the
    same slot unless it moved only among near-equal descriptor distances
    (as `_hold_filtered` allows)."""
    rng = np.random.default_rng(15)
    prob = correspondence_problem(seed=15, n=256, outlier_ratio=0.3)
    base = rng.normal(size=(256, 32)).astype(np.float32)
    d_src = base + 0.05 * rng.normal(size=base.shape).astype(np.float32)
    d_tgt = base.copy()
    out = ~prob["gt_inliers"]
    d_tgt[out] = rng.normal(size=(out.sum(), 32)).astype(np.float32)
    external.save_descriptors_npz(tmp_path / "src.npz", prob["P"], d_src)
    external.save_descriptors_npz(tmp_path / "tgt.npz", prob["Q"], d_tgt)
    src = external.load_descriptors_npz(str(tmp_path / "src.npz"))
    tgt = external.load_descriptors_npz(str(tmp_path / "tgt.npz"))
    jsrc = jexternal.load_descriptors_npz(str(tmp_path / "src.npz"))
    for k in ("xyz", "desc"):
        np.testing.assert_array_equal(src[k], jsrc[k])
    P, Q, mask = external.correspondences_from_descriptors(src, tgt, max_correspondences=200,
                                                           device="cpu")
    jP, jQ, jmask = (np.asarray(x) for x in
                     jexternal.correspondences_from_descriptors(src, tgt, max_correspondences=200))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    tm = topk.mutual_filter(topk.match_descriptors(T(d_src), T(d_tgt)), 200)
    jm = jtopk.mutual_filter(jtopk.match_descriptors(jnp.asarray(d_src), jnp.asarray(d_tgt)), 200)
    _hold_filtered(tm, jm)
    np.testing.assert_array_equal(P.numpy(), prob["P"][tm.src_idx.numpy()])
    np.testing.assert_array_equal(Q.numpy(), prob["Q"][tm.tgt_idx.numpy()])
    rows = lambda a, b: sorted(map(tuple, np.concatenate([a, b], 1)[jmask > 0].tolist()))
    assert rows(P.numpy(), Q.numpy()) == rows(jP, jQ)
    np.save(tmp_path / "bad.npy", 0)
    np.savez(tmp_path / "bad.npz", xyz=np.zeros((3, 3)), desc=np.zeros((4, 8)))
    with pytest.raises(ValueError):
        external.load_descriptors_npz(str(tmp_path / "bad.npz"))


def _twists(rng, n=64):
    """Twists with rotation angles from 0 through the Taylor guard to near pi."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    ang = np.concatenate([[0.0, 1e-5, 1e-3, 0.05, 0.0999, 0.1001, np.pi - 2e-3, np.pi - 5e-4],
                          rng.uniform(0, np.pi - 1e-2, n - 8)])
    xi = np.concatenate([rng.normal(size=(n, 3)), w * ang[:, None]], axis=-1)
    return xi.astype(np.float32)


def test_se3_matches_jax():
    """Every operation within 1e-6 (atol), on twists from 0 to near pi;
    the near-pi log within 1e-4 (its axis comes from a column of R + I)."""
    rng = np.random.default_rng(8)
    xi = _twists(rng)
    pts = rng.normal(size=(64, 10, 3)).astype(np.float32)
    close = lambda g, w, atol=1e-6: np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol)
    close(se3.hat(T(xi[:, 3:])), jse3.hat(jnp.asarray(xi[:, 3:])))
    R = se3.exp_so3(T(xi[:, 3:]))
    close(R, jse3.exp_so3(jnp.asarray(xi[:, 3:])))
    Tt = se3.exp_se3(T(xi))
    Tj = jse3.exp_se3(jnp.asarray(xi))
    close(Tt, Tj)
    Tn = T(np.asarray(Tj))                     # the same transforms on both sides from here
    near_pi = np.zeros(len(xi), bool)
    near_pi[[6, 7]] = True
    lg, jlg = se3.log_so3(Tn[:, :3, :3]).numpy(), np.asarray(jse3.log_so3(jnp.asarray(Tn[:, :3, :3].numpy())))
    close(lg[~near_pi], jlg[~near_pi])
    close(lg[near_pi], jlg[near_pi], atol=1e-4)
    ls, jls = se3.log_se3(Tn).numpy(), np.asarray(jse3.log_se3(jnp.asarray(Tn.numpy())))
    close(ls[~near_pi], jls[~near_pi], atol=2e-6)
    close(se3.inv(Tn), jse3.inv(jnp.asarray(Tn.numpy())))
    close(se3.compose(Tn, Tn.flip(0)), jse3.compose(jnp.asarray(Tn.numpy()), jnp.asarray(Tn.flip(0).numpy())))
    close(se3.adjoint(Tn), jse3.adjoint(jnp.asarray(Tn.numpy())))
    close(se3.apply(Tn, T(pts)), jse3.apply(jnp.asarray(Tn.numpy()), jnp.asarray(pts)), atol=2e-6)
    close(se3.pack(Tn[:, :3, :3], Tn[:, :3, 3]), Tn)
    # exp and log invert each other away from pi.
    close(se3.log_se3(se3.exp_se3(T(xi)))[~near_pi], xi[~near_pi], atol=2e-4)


def _cloud_pair(seed, n=1024, noise=0.002, angle=0.15, trans=0.05):
    """Two noisy views of one blob surface with a planted transform (the
    helper of tests/test_icp.py)."""
    rng = np.random.default_rng(seed)
    base = blob_cloud(rng, n_points=n)
    T_gt = se3np.random_transform(rng, max_angle_rad=angle, max_trans=trans)
    src = base + rng.normal(scale=noise, size=base.shape)
    tgt = se3np.apply_T(T_gt, base + rng.normal(scale=noise, size=base.shape))
    return src.astype(np.float32), tgt.astype(np.float32), T_gt


@pytest.mark.parametrize("masked", [False, True])
def test_nearest_neighbors_match_jax(masked):
    """Indices equal, distances within 1e-6 (the same arithmetic order)."""
    rng = np.random.default_rng(1234)
    src = rng.normal(size=(257, 3)).astype(np.float32)
    tgt = rng.normal(size=(401, 3)).astype(np.float32)
    m = (np.arange(401) < 300).astype(np.float32) if masked else None
    ji, jd = jicp.nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt), block_rows=64,
                                    mask_tgt=None if m is None else jnp.asarray(m))
    ti, td = icp.nearest_neighbors(T(src), T(tgt), block_rows=64, mask_tgt=None if m is None else T(m))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    if masked:
        assert ti.numpy().max() < 300


@pytest.fixture(scope="module")
def icp_pair():
    src, tgt, T_gt = _cloud_pair(7)
    return src, tgt, T_gt, np.asarray(jestimate_normals(jnp.asarray(tgt), k=16))


@pytest.mark.parametrize("trim", [1.0, 0.8])
@pytest.mark.parametrize("variant", ["point", "plane"])
def test_icp_matches_jax(icp_pair, variant, trim):
    """R and t within 1e-4 of the JAX package's after max_iters = 10 and
    the same matched count; trimmed runs within 5 matches, and the trimmed
    point-to-plane run within 3e-4: the distances come in steps of
    ulp(|x|^2) (the Gram form), so the trimmed set takes or drops whole
    groups of tied distances, and it does so from one iteration to the
    next in the JAX run itself (819-823 points)."""
    src, tgt, T_gt, nrm = icp_pair
    kw = dict(max_iters=10, max_corr_dist=0.1, trim_frac=trim, variant=variant)
    T0 = se3np.random_transform(np.random.default_rng(3), max_angle_rad=0.1, max_trans=0.02)
    T0 = (T0 @ T_gt).astype(np.float32)
    jr = jicp.icp(jnp.asarray(src), jnp.asarray(tgt), jicp.IcpParams(**kw), T_init=jnp.asarray(T0),
                  tgt_normals=jnp.asarray(nrm) if variant == "plane" else None)
    tr = icp.icp(T(src), T(tgt), icp.IcpParams(**kw), T_init=T(T0),
                 tgt_normals=T(nrm) if variant == "plane" else None)
    tol = 3e-4 if (variant, trim) == ("plane", 0.8) else 1e-4
    n_tol = 5 if trim < 1.0 else 0
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=tol)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=tol)
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), atol=tol)
    assert abs(int(tr.num_matched) - int(jr.num_matched)) <= n_tol
    np.testing.assert_allclose(tr.rmse_trace.numpy(), np.asarray(jr.rmse_trace), rtol=0.02)
    assert tr.rmse_trace.shape == (10,) and float(tr.rmse) == float(tr.rmse_trace[-1])
    E = tr.T.numpy().astype(np.float64) @ np.linalg.inv(T_gt)
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.5 and np.linalg.norm(E[:3, 3]) < 0.01


def test_icp_batch_matches_single_and_checks(icp_pair):
    """A batch of two pairs gives each pair's single run within 1e-6; the
    parameter checks and the plane variant's normals check are the JAX
    package's."""
    src, tgt, T_gt, _ = icp_pair
    src2, tgt2, _ = _cloud_pair(9)
    p = icp.IcpParams(max_iters=5)
    batch = icp.icp_batch(T(np.stack([src, src2])), T(np.stack([tgt, tgt2])), p)
    for b, (s, t) in enumerate(((src, tgt), (src2, tgt2))):
        one = icp.icp(T(s), T(t), p)
        np.testing.assert_allclose(batch.T[b].numpy(), one.T.numpy(), atol=1e-6)
        assert int(batch.num_matched[b]) == int(one.num_matched)
    for bad in (dict(trim_frac=0.0), dict(variant="line"), dict(max_iters=0)):
        with pytest.raises(ValueError):
            icp.IcpParams(**bad)
    with pytest.raises(ValueError):
        icp.icp(T(src), T(tgt), icp.IcpParams(variant="plane"))
    # Fewer than 3 matches within reach: the initial transform is held.
    far = icp.icp(T(src), T(tgt + 10.0), icp.IcpParams(max_iters=3))
    np.testing.assert_array_equal(far.T.numpy(), np.eye(4, dtype=np.float32))
    assert int(far.num_matched) == 0
