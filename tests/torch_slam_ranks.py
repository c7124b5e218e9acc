"""Rank bodies of tests/test_torch_slam_dist.py.

`saccot_tpu_torch.dist.local.run_ranks` spawns gloo ranks that import this
module by name, so it imports torch and the port only, never JAX. Inputs
arrive as NumPy arrays and the results go back as NumPy arrays.
"""

import numpy as np
import torch
import torch.distributed as dist

from saccot_tpu_torch.slam.ba import BAProblem, bundle_adjust
from saccot_tpu_torch.slam.dryrun import dryrun_rank
from saccot_tpu_torch.slam.posegraph import PoseGraph, optimize_pose_graph


def _rows(x: np.ndarray, rank: int, d: int) -> torch.Tensor:
    """Rank `rank`'s contiguous 1/d of the leading axis."""
    n = x.shape[0] // d
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def slam_world(ba_prob, graph, ba_kw, pgo_kw):
    """Landmark-sharded BA and edge-sharded PGO over all ranks, the same
    solves on this rank alone, and the dry runs."""
    torch.set_num_threads(1)  # several ranks and test workers share the cores
    world, r, d = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    full = BAProblem(*(torch.from_numpy(x) for x in ba_prob))
    local = BAProblem(full.poses, *(_rows(x, r, d) for x in ba_prob[1:]))
    g_full = PoseGraph(*(torch.from_numpy(x) for x in graph))
    g_local = PoseGraph(g_full.poses, *(_rows(x, r, d) for x in graph[1:]))
    return dict(
        ba=bundle_adjust(local, group=world, **ba_kw), ba_one=bundle_adjust(full, **ba_kw),
        pgo=optimize_pose_graph(g_local, group=world, **pgo_kw),
        pgo_one=optimize_pose_graph(g_full, **pgo_kw),
        dryrun=dryrun_rank("cpu"),
    )
