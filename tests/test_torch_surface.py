"""PyTorch port vs the JAX package: the public surface beyond the main path.

The dense-S triangle pool, pair and edge scores, the dense distance matrix,
the SVD fit, the SLAM checkpoint's named partner, `approx=` on the
neighbour searches, and the estimator's per-stage routes. Both sides get the
same NumPy inputs; each test states its tolerance. The pool checks mirror
tests/test_engine.py:51-80 (seed 11, the exhaustive budgets).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saccot_tpu.engine import compat as jcompat
from saccot_tpu.engine import svd3 as jsvd3
from saccot_tpu.engine import triangles as jtri
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.oracle import saccot as oracle
from saccot_tpu.utils import se3np
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch.dist.mesh import SingleRankMesh
from saccot_tpu_torch.dist.sweep import make_sweep_fn, run_sweep
from saccot_tpu_torch.engine import compat as tcompat
from saccot_tpu_torch.engine import sac_cot
from saccot_tpu_torch.engine import triangles as ttri
from saccot_tpu_torch.engine.svd3 import umeyama
from saccot_tpu_torch.features import fpfh, neighbors, shot
from saccot_tpu_torch.utils import checkpoint
from saccot_tpu_torch.utils.convert import problem_batch
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

N = 96
EXHAUSTIVE = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=N, neighbors_per_anchor=N - 1, max_hypotheses=512,
)
ROUTES = ("kernel", "plain")
SMALL = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
                     num_anchors=32, neighbors_per_anchor=8, max_hypotheses=128)
SMALL_FAST = dataclasses.replace(SMALL, dedup_triangles=False, per_anchor_candidates=4)


def _jax(params):
    return JaxSacCotParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def prob():
    return correspondence_problem(seed=11, n=N, outlier_ratio=0.5, noise=0.004)


@pytest.fixture(scope="module")
def small_batch():
    return problem_batch([5, 6], device="cpu", n=96, outlier_ratio=0.5)[:2]


# -- the dense-S pool ----------------------------------------------------------

def _ranked(pool, b=None):
    """Valid (canonical triple, score) of a pool, by descending score."""
    tri, s, v = (np.asarray(x if b is None else x[b]) for x in pool)
    order = np.argsort(-s[v], kind="stable")
    return np.sort(tri[v], axis=1)[order], s[v][order]


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("s_jk", ["S", "points"])
def test_dense_pool_matches_jax_and_oracle(prob, dedup, s_jk):
    """`triangle_pool` from the dense S of `compat_matrix` against the JAX
    package's and the oracle's clique enumeration: sorted scores within
    5e-4, and the top half of each reference's ranked triangles (above any
    tie boundary) in the port's pool. With dedup the triples are canonical
    and distinct."""
    params = dataclasses.replace(EXHAUSTIVE, dedup_triangles=dedup)
    Pt, Qt = (torch.from_numpy(prob[k])[None] for k in ("P", "Q"))
    S = tcompat.compat_matrix(Pt, Qt, params)
    pts = (Pt, Qt) if s_jk == "points" else ()
    got_tri, got_s = _ranked(ttri.triangle_pool(S, params, *pts), 0)

    Pj, Qj = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    S_j = jcompat.compat_matrix(Pj, Qj, _jax(params))
    ref_tri, ref_s = _ranked(jtri.triangle_pool(S_j, _jax(params),
                                                *((Pj, Qj) if pts else ())))
    assert len(got_s) > 50 and len(got_s) == len(ref_s)
    np.testing.assert_allclose(got_s, ref_s, atol=5e-4)
    got_set = set(map(tuple, got_tri.tolist()))
    assert set(map(tuple, ref_tri[:len(ref_s) // 2].tolist())) <= got_set

    o_tri, o_s = oracle.enumerate_triangles(oracle.compat_scores(prob["P"], prob["Q"], params))
    o_tri, o_s = oracle.rank_triangles(o_tri, o_s, params.max_hypotheses)
    # Without dedup a triangle enters once per vertex: compare distinct ones.
    have = np.sort(got_s[np.unique(got_tri, axis=0, return_index=True)[1]])[::-1]
    k = min(len(have), len(o_s))
    np.testing.assert_allclose(have[:k], np.sort(o_s)[::-1][:k], atol=5e-4)
    assert set(map(tuple, np.sort(o_tri[:k // 2], axis=1).tolist())) <= got_set
    if dedup:
        raw = ttri.triangle_pool(S, params, *pts)
        tri = raw.triples[0][raw.valid[0]].numpy()
        assert len(set(map(tuple, tri.tolist()))) == tri.shape[0]
        assert (tri[:, 0] < tri[:, 1]).all() and (tri[:, 1] < tri[:, 2]).all()


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("s_jk", ["S", "points"])
def test_dense_pool_with_a_diagonal_matches_jax(prob, dedup, s_jk):
    """A dense S with a nonzero diagonal makes each anchor its own first
    neighbour, so only the id tests keep it out of its own triangles: no
    valid triple names a node twice, and the pool is the JAX package's on
    the same S, with a budget that holds every candidate (scores within
    1e-5; from the points, a candidate whose s_jk sits within rounding of
    tau or min_separation may flip, as in tests/test_torch_large_n.py)."""
    A, B = SMALL.num_anchors, SMALL.neighbors_per_anchor
    params = dataclasses.replace(SMALL, dedup_triangles=dedup,
                                 max_hypotheses=A * B * (B - 1) // 2)
    S = np.array(jcompat.compat_matrix(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]),
                                        _jax(params)))
    np.fill_diagonal(S, 2.0)
    pts = (prob["P"], prob["Q"]) if s_jk == "points" else ()
    got = ttri.triangle_pool(torch.from_numpy(S)[None], params,
                             *(torch.from_numpy(x)[None] for x in pts))
    ref = jtri.triangle_pool(jnp.asarray(S), _jax(params), *(jnp.asarray(x) for x in pts))
    got_map = {tuple(t): s for t, s, v in zip(*(np.asarray(x[0]) for x in got)) if v}
    ref_map = {tuple(t): s for t, s, v in zip(*(np.asarray(x) for x in ref)) if v}
    assert len(ref_map) > 50
    assert all(len(set(t)) == 3 for t in got_map)
    flips = set(ref_map) ^ set(got_map)
    assert len(flips) <= (len(ref_map) // 200 if pts else 0), flips
    for tri in set(ref_map) & set(got_map):
        assert abs(ref_map[tri] - got_map[tri]) <= 1e-5


def test_dense_pool_needs_points_or_s(prob):
    Pt = torch.from_numpy(prob["P"])[None]
    with pytest.raises(ValueError, match="dense S"):
        ttri._pool_from_neighbors(torch.arange(4)[None], torch.ones((1, 4, 3)),
                                  torch.zeros((1, 4, 3), dtype=torch.int64), Pt, None, SMALL)


# -- pair scores, edge scores and distances ------------------------------------

def test_pair_and_edge_scores_match_jax(prob):
    """`pair_scores` and `edge_scores_from_points` (self-edges included)
    against the JAX package's, within 1e-5."""
    rng = np.random.default_rng(7)
    P, Q = prob["P"], prob["Q"]
    a = rng.integers(0, N, size=400)
    b = np.where(np.arange(400) % 10 == 0, a, rng.integers(0, N, size=400))
    got = ttri.pair_scores(*(torch.from_numpy(x) for x in (P[a], P[b], Q[a], Q[b])),
                           EXHAUSTIVE)
    ref = jtri.pair_scores(*(jnp.asarray(x) for x in (P[a], P[b], Q[a], Q[b])),
                           _jax(EXHAUSTIVE))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert (got > 0).sum() > 20
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got_e = ttri.edge_scores_from_points(torch.from_numpy(P)[None], torch.from_numpy(Q)[None],
                                         ta[None], tb[None], EXHAUSTIVE)[0]
    ref_e = jtri.edge_scores_from_points(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(a),
                                         jnp.asarray(b), _jax(EXHAUSTIVE))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), atol=1e-5)
    assert (got_e.numpy()[a == b] == 0).all()
    # Unbatched points take the same gather.
    np.testing.assert_array_equal(
        ttri.edge_scores_from_points(torch.from_numpy(P), torch.from_numpy(Q), ta, tb,
                                     EXHAUSTIVE).numpy(), got_e.numpy())


def test_pairwise_distances_match_jax(prob):
    """`pairwise_distances` by direct differences: within 1e-6 of float64
    everywhere, and within 1e-5 of the JAX package's wherever the distance
    is above `min_separation` (the only distances the predicate scores).
    Below it the JAX package's Gram trick gives the square root of its
    rounding, 1.4e-5 off at d = 0.012 and up to 5e-4 on the diagonal, where
    the port gives exactly 0."""
    x = np.stack([prob["P"], prob["Q"]])
    got = tcompat.pairwise_distances(torch.from_numpy(x)).numpy()
    ref = np.asarray(jcompat.pairwise_distances(jnp.asarray(x)))
    exact = np.linalg.norm(x[:, :, None].astype(np.float64) - x[:, None, :], axis=-1)
    np.testing.assert_allclose(got, exact, atol=1e-6)
    far = exact > EXHAUSTIVE.min_separation
    assert far.mean() > 0.9
    np.testing.assert_allclose(got[far], ref[far], atol=1e-5)
    assert (np.diagonal(got, axis1=1, axis2=2) == 0).all()
    assert np.diagonal(ref, axis1=1, axis2=2).max() < 1e-3


# -- the SVD fit ---------------------------------------------------------------

def test_umeyama_svd_matches_jax_and_quat():
    """`umeyama(method="svd")` against the JAX package's `method="svd"` and
    the port's `"quat"` on 32 weighted noisy sets, within 1e-5; a set of
    coincident points and a row of zero weights give the identity on all
    three."""
    rng = np.random.default_rng(1234)
    p = rng.normal(size=(32, 5, 3)).astype(np.float32)
    T = np.stack([se3np.random_transform(rng) for _ in range(32)])
    q = (se3np.apply_T(T, p.astype(np.float64))
         + rng.normal(scale=1e-3, size=p.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(32, 5)).astype(np.float32)
    p[0] = 1.0
    q[0] = 1.5
    w[1] = 0.0
    tp, tq, tw = (torch.from_numpy(x) for x in (p, q, w))
    R, t = umeyama(tp, tq, tw, method="svd")
    Rj, tj = jsvd3.umeyama(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w), method="svd")
    Rq, tq_ = umeyama(tp, tq, tw)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(R.numpy(), Rq.numpy(), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), tq_.numpy(), atol=1e-5)
    for Rx in (R.numpy(), np.asarray(Rj), Rq.numpy()):
        np.testing.assert_allclose(Rx[:2], np.broadcast_to(np.eye(3), (2, 3, 3)), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(R.numpy().astype(np.float64)), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="method"):
        umeyama(tp, tq, tw, method="polar")


# -- the SLAM checkpoint and approx= --------------------------------------------

def test_slam_state_checkpoint(tmp_path):
    """`restore_slam_state` round trip, as tests/test_io.py:216-225."""
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[2, :3, 3] = [1, 2, 3]
    lm = np.arange(12, dtype=np.float32).reshape(4, 3)
    checkpoint.save_slam_state(str(tmp_path / "slam"), poses, lm, gn_iter=3, lam=0.25)
    state = checkpoint.restore_slam_state(str(tmp_path / "slam"))
    np.testing.assert_array_equal(state["poses"], poses)
    np.testing.assert_array_equal(state["landmarks"], lm)
    assert int(state["gn_iter"]) == 3 and float(state["lam"]) == 0.25
    assert checkpoint.restore_slam_state(str(tmp_path / "none")) is None


def test_approx_searches_take_the_exact_route(prob):
    """`approx=True` on knn, SHOT and FPFH gives the exact route's bits."""
    pts = torch.from_numpy(prob["P"])
    mask = torch.arange(N) < N - 6
    for kw in (dict(exclude_self=True), dict(query_mask=mask, ref_mask=mask)):
        exact = neighbors.knn(pts, pts, 8, **kw)
        for a, b in zip(neighbors.knn(pts, pts, 8, approx=True, **kw), exact):
            assert torch.equal(a, b)
    normals = torch.nn.functional.normalize(torch.from_numpy(prob["Q"]), dim=-1)
    kp = torch.arange(0, N, 7)
    for fn in (shot.shot_descriptors, fpfh.fpfh_descriptors):
        exact = fn(pts, normals, kp, 0.4, k=16, mask=mask)
        assert torch.equal(fn(pts, normals, kp, 0.4, k=16, mask=mask, approx=True), exact)


# -- per-stage routes ---------------------------------------------------------

@pytest.mark.parametrize("config", ["exact", "fast"])
@pytest.mark.parametrize("routes", list(itertools.product(ROUTES, repeat=4)),
                         ids=lambda r: "-".join(x[0] for x in r))
def test_every_route_mix_gives_the_plain_bits_on_the_cpu(small_batch, config, routes):
    """On CPU tensors every kernel wrapper takes its plain version, so each
    mix of the four routes gives `impl="plain"`'s bits, whatever `impl`
    says for the stages a mix leaves unset."""
    params = SMALL if config == "exact" else SMALL_FAST
    P, Q = small_batch
    mask = torch.ones(P.shape[:2])
    mask[1, -10:] = 0
    want = sac_cot.register_batch(P, Q, params, mask=mask, impl="plain")
    compat, pool, solve, score = routes
    got = sac_cot.register_batch(P, Q, params, mask=mask, impl="kernel", compat_impl=compat,
                                 pool_impl=pool, solve_impl=solve, score_impl=score)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want.num_inliers.min()) > 10


@pytest.mark.parametrize("stage", ["impl", "compat_impl", "pool_impl", "solve_impl",
                                   "score_impl"])
def test_unknown_route_raises(small_batch, stage):
    P, Q = small_batch
    with pytest.raises(ValueError, match="'kernel' or 'plain'"):
        sac_cot.register_batch(P, Q, SMALL, **{stage: "pallas"})


def test_pair_forms_and_the_sweep_take_the_routes(small_batch):
    """`register_pair`, `register_pair_sp` and `register_pair_tp` without a
    group, and the sweep over a one-rank mesh, each with a mixed route: the
    bits of the batch's row."""
    P, Q = small_batch
    mix = dict(compat_impl="plain", pool_impl="kernel", solve_impl="plain", score_impl="kernel")
    want = sac_cot.register_batch(P, Q, SMALL, impl="plain")
    for got in (sac_cot.register_pair(P[1], Q[1], SMALL, **mix),
                sac_cot.register_pair_sp(P[1], Q[1], SMALL, None, **mix),
                sac_cot.register_pair_tp(P[1], Q[1], SMALL, None, **mix)):
        assert all(torch.equal(a, b[1]) for a, b in zip(got, want))
    swept = run_sweep(make_sweep_fn(SingleRankMesh(), SMALL, **mix), P, Q)
    assert all(torch.equal(a, b) for a, b in zip(swept, want))


def test_batch_bits_script_on_the_cpu(monkeypatch, capsys):
    """`scripts/exp_batch_bits` at a small point: on the CPU a pair alone has
    the batch row's bits in every field, and so does T at every batch size."""
    from saccot_tpu_torch.scripts import exp_batch_bits as xbits

    monkeypatch.setattr(xbits, "POINTS", (("bench", SMALL, range(5, 13), 96, 0.5, 0.004),))
    assert xbits.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    alone = [line for line in out if " alone: " in line]
    assert len(alone) == 2 and not any("differs" in line for line in alone)
    assert [line.split(": ")[1] for line in out if "batch of" in line] == [
        "T the whole batch's bits on 1 of 1 rows", "T the whole batch's bits on 2 of 2 rows"]
