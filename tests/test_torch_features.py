"""PyTorch port vs the JAX package: the feature stages (kNN, the closed-form
3x3 eigensolver, normals, mesh resolution, voxel grid, ISS and Harris
keypoints, SHOT and FPFH descriptors).

Both sides get the same NumPy inputs, and each stage the same upstream
arrays (the JAX side's), so one stage's last bits do not carry into the
next. The JAX functions run op by op, as tests/test_features.py runs them;
the port runs its plain route on CPU tensors. Tolerances are stated at each
test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from saccot_tpu.features import eig3 as jeig3
from saccot_tpu.features import fpfh as jfpfh
from saccot_tpu.features import harris as jharris
from saccot_tpu.features import iss as jiss
from saccot_tpu.features import neighbors as jnbr
from saccot_tpu.features import normals as jnormals
from saccot_tpu.features import shot as jshot
from saccot_tpu.features import voxel as jvoxel
from saccot_tpu.features.resolution import mesh_resolution as jmesh_resolution
from saccot_tpu.io.synthetic import blob_cloud
from saccot_tpu_torch.features import eig3, fpfh, harris, iss, neighbors, normals, shot, voxel
from saccot_tpu_torch.features.resolution import mesh_resolution

torch.set_num_threads(2)


def T(x, dtype=None):
    """A CPU tensor holding a copy of a NumPy or JAX array."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def cloud():
    """A 2,048-point blob (the ISS test's seed), its resolution, the JAX
    side's shared self-kNN (k = 32, self included) and normals."""
    pts = blob_cloud(np.random.default_rng(3), 2048).astype(np.float32)
    pr = float(jmesh_resolution(jnp.asarray(pts)))
    nbrs = jnbr.knn(jnp.asarray(pts), jnp.asarray(pts), k=32)
    nrm = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), k=16, neighbors=nbrs))
    return pts, pr, (np.asarray(nbrs[0]), np.asarray(nbrs[1])), nrm


def _near_tie_rows(d_next, k):
    """Rows whose k-th and (k+1)-th distances lie within 1e-5: there the
    selected set may legally differ."""
    return np.abs(d_next[:, k] - d_next[:, k - 1]) < 1e-5 if d_next.shape[1] > k else \
        np.zeros(d_next.shape[0], bool)


@pytest.mark.parametrize("case", ["self", "exclude_self", "masked", "query", "k1"])
def test_knn_matches_jax(cloud, case):
    """Distances atol 1e-5; indices equal except in rows whose k-th and
    (k+1)-th distances lie within 1e-5."""
    pts = cloud[0]
    rng = np.random.default_rng(11)
    q, k, kw = pts, 16, {}
    if case == "exclude_self":
        kw = dict(exclude_self=True)
    elif case == "masked":
        m = rng.random(len(pts)) < 0.8
        kw = dict(query_mask=m, ref_mask=m, exclude_self=True)
    elif case == "query":
        q, k = pts[::7] + 0.01, 48
    elif case == "k1":
        k, kw = 1, dict(exclude_self=True)
    jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    tkw = {n: T(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    jd, ji = (np.asarray(x) for x in jnbr.knn(jnp.asarray(q), jnp.asarray(pts), k=k,
                                                block_rows=512, **jkw))
    jd_next = np.asarray(jnbr.knn(jnp.asarray(q), jnp.asarray(pts), k=k + 1, **jkw)[0])
    td, ti = neighbors.knn(T(q), T(pts), k=k, block_rows=512, **tkw)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-5)
    rows = ~_near_tie_rows(jd_next, k)
    np.testing.assert_array_equal(ti.numpy()[rows], ji[rows])
    if case == "masked":
        assert (td.numpy()[~m] >= 1e29).all() and (ti.numpy()[~m] == 0).all()
        ok = neighbors.neighbor_validity(td)
        assert m[ti.numpy()[ok.numpy()]].all()


def _covariances():
    rng = np.random.default_rng(1234)
    A = rng.normal(size=(256, 5, 3)).astype(np.float32)
    C = np.einsum("nki,nkj->nij", A, A) / 5.0
    C[0] = np.eye(3) * 2.7                              # isotropic
    C[1] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])   # rank 1
    C[2] = np.diag([1.0, 1.0, 0.0])                     # rank 2, repeated
    C[3] = 0.0                                          # zero: isotropic
    C[4] = np.diag([1e-6, 2e-6, 5.0])                   # near-planar
    return C.astype(np.float32)


def test_eig3_matches_jax():
    """Eigenvalues within 1e-5 of the trace; the smallest eigenvector and
    the extreme pair within 1e-4, isotropic inputs skipped."""
    C = _covariances()
    ev, jev = eig3.eigvals3_sym(T(C)).numpy(), np.asarray(jeig3.eigvals3_sym(jnp.asarray(C)))
    trace = np.trace(C, axis1=1, axis2=2)[:, None]
    assert (np.abs(ev - jev) <= 1e-5 * np.maximum(trace, 1e-12)).all()
    aniso = np.ones(len(C), bool)
    aniso[[0, 3]] = False
    v = eig3.smallest_eigvec3_sym(T(C)).numpy()
    np.testing.assert_allclose(v[aniso], np.asarray(jeig3.smallest_eigvec3_sym(jnp.asarray(C)))[aniso],
                               atol=1e-4)
    vs, vl = (x.numpy() for x in eig3.extreme_eigvecs3_sym(T(C)))
    jvs, jvl = (np.asarray(x) for x in jeig3.extreme_eigvecs3_sym(jnp.asarray(C)))
    np.testing.assert_allclose(vs[aniso], jvs[aniso], atol=1e-4)
    np.testing.assert_allclose(vl[aniso], jvl[aniso], atol=1e-4)
    # The fallbacks (isotropic inputs) are the same fixed vectors.
    np.testing.assert_array_equal(v[~aniso], np.asarray(jeig3.smallest_eigvec3_sym(jnp.asarray(C)))[~aniso])


@pytest.mark.parametrize("viewpoint", [None, (0.0, 0.0, 10.0)])
def test_normals_and_covariance_match_jax(cloud, viewpoint):
    """Normals atol 1e-4 with the same signs, fed the same neighbours; also
    through the port's own kNN; the covariance atol 1e-7."""
    pts, _, (d, i), _ = cloud
    vp = None if viewpoint is None else np.asarray(viewpoint, np.float32)
    want = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), k=16, neighbors=(d, i),
                                                viewpoint=None if vp is None else jnp.asarray(vp)))
    got = normals.estimate_normals(T(pts), k=16, neighbors=(T(d), T(i, torch.long)),
                                   viewpoint=None if vp is None else T(vp)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert ((got * want).sum(-1) > 0).all()
    own = normals.estimate_normals(T(pts), k=16, viewpoint=None if vp is None else T(vp)).numpy()
    np.testing.assert_allclose(own, want, atol=1e-4)
    valid = d[:, :16] < 0.2
    jc, jmu = jnormals.neighborhood_covariance(jnp.asarray(pts), jnp.asarray(i[:, :16]),
                                               jnp.asarray(valid))
    tc, tmu = normals.neighborhood_covariance(T(pts), T(i[:, :16], torch.long), T(valid))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_mesh_resolution_matches_jax(cloud, masked):
    """Within 1e-6 relative (the mean is summed in another order)."""
    pts = cloud[0]
    m = (np.random.default_rng(5).random(len(pts)) < 0.7) if masked else None
    want = float(jmesh_resolution(jnp.asarray(pts), None if m is None else jnp.asarray(m)))
    got = float(mesh_resolution(T(pts), None if m is None else T(m)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("case", ["plain", "masked", "over_budget"])
def test_voxel_downsample_matches_jax(case):
    """Centroids atol 1e-6, masks equal; voxels past the budget dropped in
    the same (sort) order."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    m = rng.random(2000) < 0.75 if case == "masked" else None
    size, budget = (0.2, 64) if case == "over_budget" else (0.25, 512)
    jc, jv = jvoxel.voxel_downsample(jnp.asarray(pts), size, budget,
                                     None if m is None else jnp.asarray(m))
    tc, tv = voxel.voxel_downsample(T(pts), size, budget, None if m is None else T(m))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert tv.numpy().sum() == (budget if case == "over_budget" else np.asarray(jv).sum())


def _hold_keypoints(got, want):
    """The same keypoints in the same order. The eigenvalues carry XLA's and
    torch's own `acos`/`cos` roundings (l3 within about 4e-5 relative), so a
    point whose response lies within that of a neighbour's may flip its NMS
    decision: at most one index on each side is the other's odd one out,
    the common indices come in the same order with saliencies within 1e-4
    relative; unused slots hold -1.0."""
    gi, wi = got.idx.numpy()[got.valid.numpy()], np.asarray(want.idx)[np.asarray(want.valid)]
    assert len(set(gi) - set(wi)) <= 1 and len(set(wi) - set(gi)) <= 1, (gi, wi)
    common = set(gi) & set(wi)
    g = [x for x in gi if x in common]
    w = [x for x in wi if x in common]
    assert g == w
    gs = dict(zip(gi, got.saliency.numpy()[got.valid.numpy()]))
    ws = dict(zip(wi, np.asarray(want.saliency)[np.asarray(want.valid)]))
    np.testing.assert_allclose([gs[x] for x in g], [ws[x] for x in w], rtol=1e-4)
    assert (got.saliency.numpy()[~got.valid.numpy()] == -1.0).all()


@pytest.mark.parametrize("shared", [True, False])
def test_iss_keypoints_match_jax(cloud, shared):
    pts, pr, (d, i), _ = cloud
    kw = dict(salient_radius=5 * pr, nms_radius=3 * pr, max_keypoints=256)
    want = jiss.iss_keypoints(jnp.asarray(pts), neighbors=(d, i) if shared else None, **kw)
    got = iss.iss_keypoints(T(pts), neighbors=(T(d), T(i, torch.long)) if shared else None, **kw)
    _hold_keypoints(got, want)
    np.testing.assert_array_equal(got.xyz.numpy(), pts[got.idx.numpy()])


def test_harris_keypoints_match_jax(cloud):
    pts, pr, _, nrm = cloud
    kw = dict(radius=5 * pr, nms_radius=3 * pr, max_keypoints=256)
    want = jharris.harris_keypoints(jnp.asarray(pts), jnp.asarray(nrm), **kw)
    got = harris.harris_keypoints(T(pts), T(nrm), **kw)
    _hold_keypoints(got, want)


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("kind", ["shot", "fpfh"])
def test_descriptors_match_jax(cloud, kind, soft):
    """SHOT [M, 352] and FPFH [M, 33] atol 1e-5, hard and soft binning, at
    the JAX side's ISS keypoints with its normals."""
    pts, pr, (d, i), nrm = cloud
    kp = np.asarray(jiss.iss_keypoints(jnp.asarray(pts), salient_radius=5 * pr, nms_radius=3 * pr,
                                       max_keypoints=256, neighbors=(d, i)).idx)
    jfn, tfn = (jshot.shot_descriptors, shot.shot_descriptors) if kind == "shot" else \
        (jfpfh.fpfh_descriptors, fpfh.fpfh_descriptors)
    want = np.asarray(jfn(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(kp), 10 * pr, k=48,
                          soft=soft))
    got = tfn(T(pts), T(nrm), T(kp, torch.long), 10 * pr, k=48, soft=soft).numpy()
    assert got.shape == want.shape == (256, 352 if kind == "shot" else 33)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
