"""PyTorch port vs the JAX package: pose-graph optimization (dense and PCG).

Both sides get the graphs of tests/test_slam.py (`_make_pg_problem`, the
same NumPy draws); the JAX side runs jitted, as tests/test_slam.py runs it.
Each side's cost of every tried step is read from inside its own loop (the
JAX package's through `jax.debug.callback`), so the two Levenberg-Marquardt
schedules can be held step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_slam as jts
from saccot_tpu.slam import posegraph as jpg
from saccot_tpu_torch.slam import posegraph as tpg
from saccot_tpu_torch.slam import sparse

torch.set_num_threads(2)


def _tgraph(g) -> tpg.PoseGraph:
    return tpg.PoseGraph(*(None if x is None else torch.from_numpy(np.array(x)) for x in g))


def _tries(mod, monkeypatch, jitted):
    """Record the cost of the initial iterate and of every tried step that
    `mod.optimize_pose_graph` computes (its module-level `graph_cost`)."""
    costs = []
    orig = mod.graph_cost

    def rec(*a, **k):
        c = orig(*a, **k)
        if jitted:
            jax.debug.callback(lambda v: costs.append(float(v)), c, ordered=True)
        else:
            costs.append(float(c))
        return c

    monkeypatch.setattr(mod, "graph_cost", rec)
    return costs


def _decisions(costs, rel=1e-6):
    """Per tried step: True (accepted), False (rejected) or None where the
    tried cost is within `rel` of the current one (a float-level tie, where
    the `<=` test may go either way between two summation orders)."""
    cur, out = costs[0], []
    for c in costs[1:]:
        out.append(None if abs(c - cur) <= rel * abs(cur) else c <= cur)
        if c <= cur:
            cur = c
    return out


CASES = [(12, "dense", None), (12, "dense", "huber"), (12, "dense", "dcs"),
         (40, "pcg", None), (40, "pcg", "huber"), (40, "pcg", "dcs"),
         (40, "dense", "huber"), (12, "pcg", "dcs")]


@pytest.mark.parametrize("M,solver,robust", CASES)
def test_pose_graph_matches_jax(M, solver, robust, monkeypatch):
    """optimize_pose_graph against the JAX package (10 LM steps, delta 3,
    cg_iters 128): poses within 1e-4 and the same accept/reject decision at
    every step whose tried cost differs from the current one by more than
    1e-6 relative. After convergence the tried costs of the two sides tie at
    float precision and those decisions may differ; they move the poses by
    less than the tolerance."""
    graph, gt = jts._make_pg_problem(seed=3, M=M)
    kw = dict(iters=10, robust=robust, delta=3.0, solver=solver, cg_iters=128)
    jax.clear_caches()  # trace again, so the recorder is in the program
    jcosts = _tries(jpg, monkeypatch, jitted=True)
    try:
        ref = jpg.optimize_pose_graph(graph, **kw)
        ref_poses = np.asarray(ref.poses)
        jax.effects_barrier()
    finally:
        jax.clear_caches()  # no later caller meets the recorder
    tcosts = _tries(tpg, monkeypatch, jitted=False)
    got = tpg.optimize_pose_graph(_tgraph(graph), **kw)
    np.testing.assert_allclose(got.poses.numpy(), ref_poses, atol=1e-4)
    assert len(jcosts) == len(tcosts) == 11
    dj, dt = _decisions(jcosts), _decisions(tcosts)
    firm = [k for k in range(10) if dj[k] is not None and dt[k] is not None]
    assert [dj[k] for k in firm] == [dt[k] for k in firm], (jcosts, tcosts)
    assert dj[0] and dt[0], "the first step must be taken"
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost), rtol=1e-4)
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-5)


def test_edge_jacobians_match_jax():
    """The forward-mode Jacobians against `jax.jacfwd`: generic edges and
    exact measurements (r = 0, the small-angle branches), atol 1e-5."""
    graph, _ = jts._make_pg_problem(seed=4, M=10)
    exact, _ = jts._make_pg_problem(seed=5, M=6, noise=0.0, loop_noise=0.0)
    for g in (graph, exact):
        poses = np.array(g.poses)
        Ti, Tj, Z = poses[np.asarray(g.edge_i)], poses[np.asarray(g.edge_j)], np.array(g.meas)
        r_ref, Ji_ref, Jj_ref = jax.jit(jax.vmap(jpg._edge_jacobians))(
            jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Z))
        r, Ji, Jj = tpg._edge_jacobians(*(torch.from_numpy(x) for x in (Ti, Tj, Z)))
        for a, b in ((r, r_ref), (Ji, Ji_ref), (Jj, Jj_ref)):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_robust_weights_and_costs_match_jax():
    s = np.concatenate([[0.0, 1e-14, 0.5, 1.0, 9.0, 9.5], np.geomspace(1e-6, 1e4, 40)])
    s = s.astype(np.float32)
    for robust in (None, "none", "huber", "dcs", "tls"):
        for delta in (1.0, 3.0):
            np.testing.assert_allclose(
                tpg.robust_weight(torch.from_numpy(s), robust, delta).numpy(),
                np.asarray(jpg.robust_weight(jnp.asarray(s), robust, delta)), rtol=1e-6)
            np.testing.assert_allclose(
                tpg.robust_cost(torch.from_numpy(s), robust, delta).numpy(),
                np.asarray(jpg.robust_cost(jnp.asarray(s), robust, delta)), rtol=1e-6)
    with pytest.raises(ValueError):
        tpg.robust_weight(torch.ones(2), "cauchy", 1.0)


def test_graph_cost_edge_errors_and_chain_match_jax():
    graph, _ = jts._make_pg_problem(seed=6, M=16)
    info = np.stack([np.diag(np.linspace(1.0, 3.0, 6))] * graph.meas.shape[0]).astype(np.float32)
    g_info = graph._replace(info=jnp.asarray(info))
    for g in (graph, g_info):
        tg = _tgraph(g)
        np.testing.assert_allclose(tpg.edge_errors(tg.poses, tg).numpy(),
                                   np.asarray(jax.jit(jpg.edge_errors)(g.poses, g)), rtol=1e-5,
                                   atol=1e-9)
        for robust in (None, "huber"):
            ref = jax.jit(jpg.graph_cost, static_argnums=(2,))(g.poses, g, robust, 3.0)
            np.testing.assert_allclose(float(tpg.graph_cost(tg.poses, tg, robust, 3.0)),
                                       float(ref), rtol=1e-5)
    meas = np.array(graph.meas)[:15]
    np.testing.assert_allclose(tpg.odometry_chain_init(torch.from_numpy(meas)).numpy(),
                               np.asarray(jax.jit(jpg.odometry_chain_init)(jnp.asarray(meas))),
                               atol=1e-5)


def test_pose_graph_converges_and_zero_cost():
    """tests/test_slam.py's convergence checks on the port: loop closures
    pull the drift back (ATE < 0.1 and < 0.6 x odometry); exact
    measurements reach cost < 1e-8."""
    graph, gt = jts._make_pg_problem(seed=1, M=12)
    res = tpg.optimize_pose_graph(_tgraph(graph), iters=10)
    assert float(res.final_cost) <= float(res.initial_cost)
    ate_opt = jts.ate_rmse(res.poses.double().numpy(), gt)
    ate_init = jts.ate_rmse(np.asarray(graph.poses, np.float64), gt)
    assert ate_opt < 0.1 and ate_opt < 0.6 * ate_init, (ate_opt, ate_init)
    graph, _ = jts._make_pg_problem(seed=2, M=8, noise=0.0, loop_noise=0.0)
    assert float(tpg.optimize_pose_graph(_tgraph(graph), iters=5).final_cost) < 1e-8


def test_false_loop_closure_robust_losses():
    """One planted confidently-wrong loop closure (tests/test_slam.py): TLS
    stays within 2x of the clean run, the plain solve is visibly corrupted,
    DCS tempers it and Huber is never worse than plain."""
    rng = np.random.default_rng(7)
    graph, gt = jts._make_pg_problem(seed=3, M=12)
    bad = _tgraph(jts._plant_false_loop(graph, 2, 9, rng, weight=200.0))
    ate = {}
    ate["clean"] = jts.ate_rmse(tpg.optimize_pose_graph(
        _tgraph(graph), iters=20, robust="tls", delta=1.0).poses.double().numpy(), gt)
    for robust in ("tls", None, "dcs", "huber"):
        res = tpg.optimize_pose_graph(bad, iters=20, robust=robust, delta=1.0)
        ate[robust] = jts.ate_rmse(res.poses.double().numpy(), gt)
    assert ate["tls"] < max(2.0 * ate["clean"], 0.02), ate
    assert ate[None] > 2.0 * ate["tls"], ate
    assert ate["dcs"] < 0.5 * ate[None], ate
    assert ate["huber"] <= ate[None] + 1e-6, ate


def test_solver_switches_at_dense_pgo_max_poses():
    """solver=None is "dense" up to DENSE_PGO_MAX_POSES poses and "pcg"
    above (the same bits as naming the solver); unknown solvers and a group
    with the dense solver are refused."""
    M = jpg.DENSE_PGO_MAX_POSES
    assert tpg.DENSE_PGO_MAX_POSES == M == 64
    for m, solver in ((M, "dense"), (M + 1, "pcg")):
        g = _tgraph(jts._make_pg_problem(seed=11, M=m)[0])
        auto = tpg.optimize_pose_graph(g, iters=2)
        named = tpg.optimize_pose_graph(g, iters=2, solver=solver)
        assert torch.equal(auto.poses, named.poses)
    with pytest.raises(ValueError):
        tpg.optimize_pose_graph(g, iters=1, solver="lu")
    with pytest.raises(ValueError):
        tpg.optimize_pose_graph(g, iters=1, solver="dense", group=object())


def test_pcg_scales_to_hundreds_of_poses():
    """M=256 with loop closures on the auto-selected PCG path
    (tests/test_slam.py): cost falls, ATE < 0.5 x odometry and < 0.2."""
    graph, gt = jts._make_pg_problem(seed=9, M=256, noise=0.02)
    res = tpg.optimize_pose_graph(_tgraph(graph), iters=12)
    assert float(res.final_cost) < float(res.initial_cost)
    ate_opt = jts.ate_rmse(res.poses.double().numpy(), gt)
    ate_init = jts.ate_rmse(np.asarray(graph.poses, np.float64), gt)
    assert ate_opt < 0.5 * ate_init and ate_opt < 0.2, (ate_opt, ate_init)


def test_segment_sum_is_fixed_order_and_exact():
    """Padded segment rows: the same sums as an index_add (within rounding),
    zero entries left out change the sums by rounding only, and the bits
    repeat."""
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 7, (500,), generator=g)
    vals = torch.randn((500, 6, 6), generator=g)
    keep = torch.rand(500, generator=g) > 0.3
    seg = sparse.segments(ids, 9)
    got = sparse.segment_sum(vals, seg)
    ref = torch.zeros((9, 6, 6)).index_add_(0, ids, vals)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, sparse.segment_sum(vals, seg))
    assert (got[7:] == 0).all()
    kept = sparse.segment_sum(vals * keep[:, None, None], sparse.segments(ids, 9, keep=keep))
    torch.testing.assert_close(kept, sparse.segment_sum(vals * keep[:, None, None], seg),
                               rtol=1e-5, atol=1e-5)


def test_cg_matches_jax_scipy_cg():
    """`sparse.cg` against `jax.scipy.sparse.linalg.cg` with a Jacobi
    preconditioner: the same stopping rule (|r| <= tol |b|), the iterate
    within 1e-5 at every maxiter, and the early exit changes nothing."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 30))
    A = (A @ A.T + 30 * np.eye(30)).astype(np.float32)
    b = rng.normal(size=(30,)).astype(np.float32)
    d = np.diag(A).copy()
    tA, tb, td = torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(d)
    for tol, maxiter in ((1e-6, 64), (1e-3, 64), (1e-8, 5), (1e-8, 12)):
        ref, _ = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                                            tol=tol, maxiter=maxiter, M=lambda x: x / d)
        got = sparse.cg(lambda x: tA @ x, tb, tol, maxiter, lambda x: x / td)
        # No stop check before maxiter: all maxiter steps run.
        full = sparse.cg(lambda x: tA @ x, tb, tol, maxiter, lambda x: x / td,
                         check_every=maxiter + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        assert torch.equal(got, full)


def test_problem_generators_match_the_jax_tests():
    """`slam/problems.py` restates tests/test_slam.py's generators: the same
    draws (edges, measurements, observations bit for bit; the chained
    initial poses within 1e-5) and the same ATE."""
    from saccot_tpu_torch.slam import problems

    for kw in (dict(seed=3, M=12), dict(seed=9, M=40, noise=0.02), dict(seed=2, M=8, loop=False)):
        ref, gt_ref = jts._make_pg_problem(**kw)
        got, gt = problems.pose_graph_problem(device="cpu", **kw)
        np.testing.assert_array_equal(gt, gt_ref)
        for name in ("edge_i", "edge_j", "meas", "weight"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-5)
        assert problems.ate_rmse(got.poses.double().numpy(), gt) == \
            jts.ate_rmse(got.poses.double().numpy(), gt)
    ref, gtp_ref, gtl_ref = jts._make_ba_problem(seed=8, M=10, L=128, G=4, noise=0.005,
                                                 init_noise=0.03)
    got, gtp, gtl = problems.ba_problem(seed=8, M=10, L=128, G=4, noise=0.005, init_noise=0.03,
                                        device="cpu")
    np.testing.assert_array_equal(gtp, gtp_ref)
    np.testing.assert_array_equal(gtl, gtl_ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
