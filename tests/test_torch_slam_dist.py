"""The port's sharded SLAM solvers on two gloo ranks against one rank.

`saccot_tpu_torch.dist.local.run_ranks` spawns the ranks (rank bodies in
tests/torch_slam_ranks.py, no JAX); each rank runs the sharded solve over
the group of both and the same solve alone, on CPU tensors. The problems
are tests/test_slam.py's, and the bounds those of its sharded tests
(`test_ba_sharded_matches_single_device`,
`test_pgo_edge_sharded_matches_single_device`).
"""

import numpy as np
import pytest
import torch

import test_slam as jts
import torch_slam_ranks
from saccot_tpu_torch.dist.local import run_ranks

torch.set_num_threads(2)


def _pad_edges(graph, d):
    """The graph's edges padded to a multiple of d with weight-0 identity
    edges, which add nothing to the cost or the normal equations."""
    E = int(graph.edge_i.shape[0])
    pad = -(-E // d) * d - E
    return (np.array(graph.poses),
            np.pad(np.asarray(graph.edge_i, np.int64), (0, pad)),
            np.pad(np.asarray(graph.edge_j, np.int64), (0, pad)),
            np.concatenate([np.asarray(graph.meas), np.tile(np.eye(4, dtype=np.float32),
                                                             (pad, 1, 1))]),
            np.pad(np.asarray(graph.weight), (0, pad)))


@pytest.fixture(scope="module")
def world2():
    prob, _, _ = jts._make_ba_problem(seed=5, L=64, M=6)
    graph, gt = jts._make_pg_problem(seed=21, M=40)
    ranks = run_ranks(torch_slam_ranks.slam_world, 2, "gloo",
                      tuple(np.array(x) for x in prob), _pad_edges(graph, 2),
                      dict(iters=6), dict(iters=8, robust="huber", delta=3.0, solver="pcg",
                                          cg_iters=128), timeout=300)
    return ranks, gt


def test_ba_sharded_matches_one_rank(world2):
    """Landmarks split over two ranks: poses and the gathered landmarks
    within 2e-4 of one rank's solve, final cost within 1e-3."""
    ranks, _ = world2
    one = ranks[0]["ba_one"]
    for res in ranks:
        np.testing.assert_allclose(res["ba"].poses, one.poses, atol=2e-4)
        assert abs(float(res["ba"].final_cost) - float(one.final_cost)) < 1e-3
        assert float(res["ba"].final_cost) == float(ranks[0]["ba"].final_cost)
    landmarks = np.concatenate([r["ba"].landmarks for r in ranks])
    np.testing.assert_allclose(landmarks, one.landmarks, atol=2e-4)
    np.testing.assert_array_equal(ranks[0]["ba"].poses, ranks[1]["ba"].poses)


def test_pgo_edge_sharded_matches_one_rank(world2):
    """Edges split over two ranks, poses replicated: the same LM schedule
    and poses within 1e-5 of one rank's PCG solve; ATE < 0.1."""
    ranks, gt = world2
    one = ranks[0]["pgo_one"]
    for res in ranks:
        np.testing.assert_allclose(res["pgo"].poses, one.poses, atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["pgo"].poses, ranks[1]["pgo"].poses)
    assert jts.ate_rmse(ranks[0]["pgo"].poses.astype(np.float64), gt) < 0.1


def test_dryruns_on_two_ranks(world2):
    """`slam.dryrun.dryrun_rank` (the chip script's rank body): both dry
    runs lower their cost over two ranks and match the one-rank runs of the
    same problems."""
    ranks, _ = world2
    for res in ranks:
        d = res["dryrun"]
        assert d["world"] == 2 and d["backend"] == "gloo"
        for name in ("ba", "pgo"):
            assert float(d[name].final_cost) <= float(d[name].initial_cost) + 1e-9
            np.testing.assert_allclose(d[name].poses, d[f"{name}_one"].poses, atol=2e-4)
        assert d["ba"].landmarks.shape == (32, 3)
