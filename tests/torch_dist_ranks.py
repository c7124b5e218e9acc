"""Rank bodies of tests/test_torch_dist.py.

`saccot_tpu_torch.dist.local.run_ranks` spawns gloo ranks that import this
module by name, so it imports torch and the port only, never JAX. Inputs
arrive as NumPy arrays and the results go back as NumPy arrays.
"""

import dataclasses
import os

import numpy as np
import torch

from saccot_tpu_torch.dist.local import RANK_VARS
from saccot_tpu_torch.dist.mesh import axis_group, make_mesh
from saccot_tpu_torch.dist.ring import degrees_ring
from saccot_tpu_torch.dist.sweep import make_sweep_fn, run_sweep
from saccot_tpu_torch.engine import triangles as ttri
from saccot_tpu_torch.engine.sac_cot import (
    VALID_COUNTS, register_batch_sp, register_batch_tp, register_pair_sp, register_pair_tp,
)
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.utils.convert import KITTI_SEED, kitti_problem_batch, problem_batch


def _shard(x: np.ndarray, rank: int, d: int) -> torch.Tensor:
    """Rank `rank`'s contiguous 1/d of a [N, ...] array, as a batch of one."""
    n = x.shape[0] // d
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))[None]


def _sp(prob, params, group, rank, d):
    P, Q, m = (_shard(x, rank, d) for x in prob)
    return register_batch_sp(P, Q, params, group, mask_loc=m)


def _ring_degrees(prob, params, group, rank, d):
    P, Q, m = (_shard(x, rank, d) for x in prob)
    return degrees_ring(P, Q, params, group, mask_loc=m)


def world2(probs, params, ring_params, fast_params):
    """Every two-rank case: how the rank joined, ring degrees, SP
    (all-gather, ring, masked, anchor-sharded; batch and per-pair forms),
    the anchor-sharded pool on replicated inputs, TP (both forms)."""
    torch.set_num_threads(1)  # several ranks and test workers share the cores
    dist = torch.distributed
    out = {"init": dict(rank=dist.get_rank(), world=dist.get_world_size(),
                        backend=dist.get_backend(),
                        env=[k for k in RANK_VARS if k in os.environ])}
    mesh = make_mesh(pairs=1, corr=2)
    g, r = axis_group(mesh, "corr"), mesh.get_local_rank("corr")
    out["ring_deg"] = _ring_degrees(probs["deg"], params, g, r, 2)
    for key, prm in (("allgather", params), ("ring", ring_params), ("masked", params),
                     ("anchor", fast_params)):
        out[key] = _sp(probs[key], prm, g, r, 2)
        if key == "masked":
            out["masked_counts"] = (VALID_COUNTS[-1].n_valid.numpy(), VALID_COUNTS[-1].local)
        P, Q, m = (_shard(x, r, 2)[0] for x in probs[key])
        out["pair_" + key] = register_pair_sp(P, Q, prm, g, mask_loc=m)
    P, Q = (torch.from_numpy(x)[None] for x in probs["anchor"][:2])
    deg = kcompat.degrees(P, Q, P, Q, fast_params)
    out["pool"] = ttri.triangle_pool_from_points(P, Q, deg, fast_params, anchor_group=g)
    tp = make_mesh(pairs=1, hyp=2)
    P, Q, m = (torch.from_numpy(x)[None] for x in probs["tp"])
    out["tp"] = register_batch_tp(P, Q, params, axis_group(tp, "hyp"), mask=m)
    out["pair_tp"] = register_pair_tp(P[0], Q[0], params, axis_group(tp, "hyp"), mask=m[0])
    return out


def world4(ring_prob, P_all, Q_all, params):
    """Ring degrees over four ranks, and the sweep over a (pairs=2, corr=2) mesh."""
    torch.set_num_threads(1)
    mesh = make_mesh(pairs=1, corr=4)
    out = {"ring_deg": _ring_degrees(ring_prob, params, axis_group(mesh, "corr"),
                                     mesh.get_local_rank("corr"), 4)}
    sweep = make_sweep_fn(make_mesh(pairs=2, corr=2), params)
    out["sweep"] = run_sweep(sweep, torch.from_numpy(P_all), torch.from_numpy(Q_all))
    return out


def cards(kitti_params, bench_params):
    """Two ranks with a card each (NCCL): SP with the ring at the kitti
    configuration, TP and DP at a bench-point batch."""
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"device": dev.index, "backend": torch.distributed.get_backend()}
    sp = make_mesh(pairs=1, corr=2)
    g, r = axis_group(sp, "corr"), sp.get_local_rank("corr")
    P, Q, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev)
    n = P.shape[1] // 2
    _build.reset_launches()
    out["sp_ring"] = register_batch_sp(P[:, r * n:(r + 1) * n].contiguous(),
                                       Q[:, r * n:(r + 1) * n].contiguous(),
                                       dataclasses.replace(kitti_params, ring_compat=True), g)
    torch.cuda.synchronize()
    out["launches"] = _build.launches()
    P, Q, _ = problem_batch(range(1000, 1032), device=dev, n=1000, outlier_ratio=0.8,
                            noise=0.004)
    out["tp"] = register_batch_tp(P, Q, bench_params, axis_group(make_mesh(pairs=1, hyp=2), "hyp"))
    out["dp"] = make_sweep_fn(make_mesh(pairs=2), bench_params)(P, Q)
    return out
