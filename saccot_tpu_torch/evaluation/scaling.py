"""Scaling-efficiency harness: pairs/s of the DP sweep at growing world
sizes (port of `saccot_tpu/evaluation/scaling.py`).

Reports efficiency = rate(d) / (d * rate(1)) at each world size d. The mesh
(`dist/mesh.make_mesh`) spans the whole default group, so each size d > 1
is a run of its own on d spawned ranks (`dist/local.run_ranks`), rank 0
returning the rate; size 1 runs in the calling process on the one-rank
mesh. Only ranks on cards of their own measure scaling: ranks that share
one card (gloo) check the mechanics. Each timed region ends in a host copy
of the result.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from saccot_tpu_torch.dist.local import run_ranks
from saccot_tpu_torch.dist.mesh import axis_size, make_mesh
from saccot_tpu_torch.dist.sweep import make_sweep_fn
from saccot_tpu_torch.io.synthetic import correspondence_problem
from saccot_tpu_torch.utils.params import SacCotParams


def sweep_rate(params: SacCotParams, n_corr: int, pairs_per_device: int, reps: int,
               corr: int, device) -> float:
    """Pairs/s of the sweep over every rank of this process's group (or over
    this process alone), pairs_per_device pairs a rank of the pairs axis."""
    mesh = make_mesh(corr=corr)
    B = pairs_per_device * axis_size(mesh, "pairs")
    probs = [correspondence_problem(seed=1000 + s, n=n_corr, outlier_ratio=0.7)
             for s in range(B)]
    P = torch.as_tensor(np.stack([p["P"] for p in probs]), device=device)
    Q = torch.as_tensor(np.stack([p["Q"] for p in probs]), device=device)
    mask = torch.ones((B, n_corr), dtype=torch.float32, device=device)
    sweep = make_sweep_fn(mesh, params)
    sweep(P, Q, mask).num_inliers.cpu()  # warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        r = sweep(P, Q, mask)
    r.num_inliers.cpu()
    return B * reps / (time.perf_counter() - t0)


def _rank_rate(params, n_corr, pairs_per_device, reps, corr, device_type):
    """One rank of a world size's run (spawned by `run_ranks`)."""
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    return sweep_rate(params, n_corr, pairs_per_device, reps, corr, device)


def measure_scaling(
    params: SacCotParams,
    n_corr: int = 512,
    pairs_per_device: int = 8,
    reps: int = 5,
    corr: int = 1,
    device_counts: Optional[List[int]] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> Dict:
    """Throughput at each world size; returns rates + efficiencies.

    device_counts defaults to the powers of two up to the cards present
    (1 on the CPU); `backend` is `run_ranks`'s (None: NCCL with a card per
    rank, else gloo)."""
    device = torch.device(device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]

    results = {}
    for d in device_counts:
        c = min(corr, d)
        if d == 1:
            results[d] = sweep_rate(params, n_corr, pairs_per_device, reps, c, device)
        else:
            results[d] = run_ranks(_rank_rate, d, backend, params, n_corr, pairs_per_device,
                                   reps, c, device.type)[0]

    base = results[device_counts[0]] / device_counts[0]
    efficiency = {d: results[d] / (d * base) for d in device_counts}
    return dict(
        pairs_per_sec=results,
        efficiency=efficiency,
        device_counts=device_counts,
    )
