"""Sampler-ablation harness: the paper's headline comparison, batched.

Port of `saccot_tpu/evaluation/ablation.py`. Triangle-guided sampling
(SAC-COT) should register more pairs than edge-guided sampling, and that
more than uniform random sampling, at the same sample budget, with the gap
widening as the outlier rate rises and the budget shrinks. This runs the
experiment as one batched call per (sampler, outlier rate) cell:

    sweep = run_sampler_ablation(params, outlier_ratios=[0.8, 0.9, 0.95])
    sweep["recall"]["saccot"][0.95]

Samplers (all sharing the solve, scoring and refine; engine/baselines.py):

  random  — classic 3-point RANSAC, K uniform triples
  edge    — top-K compatibility edges + random third point
  saccot  — ranked compatibility triangles (the full estimator,
            `register_batch`)

A pair is registered under the rotation / translation error criterion
(evaluation/metrics.py). The problems and the per-pair seeds are the JAX
package's; the random draws are the port's own (`engine/baselines.py`).
The points of the JAX package's recorded ablation (`BASELINE.md`, the CLI's
`ablate` on the object-scale estimator parameters) are restated at the end.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from saccot_tpu_torch.engine.baselines import edge_guided_register_batch, ransac_register_batch
from saccot_tpu_torch.engine.sac_cot import register_batch
from saccot_tpu_torch.io.synthetic import correspondence_problem
from saccot_tpu_torch.utils import se3np
from saccot_tpu_torch.utils.params import SacCotParams

SAMPLERS = ("random", "edge", "saccot")


def _batched_estimators(params: SacCotParams, impl: str):
    """One (P [B, N, 3], Q [B, N, 3], seeds [B]) -> T [B, 4, 4] map per sampler."""
    return {
        "random": lambda P, Q, s: ransac_register_batch(P, Q, params, seeds=s, impl=impl).T,
        "edge": lambda P, Q, s: edge_guided_register_batch(P, Q, params, seeds=s, impl=impl).T,
        # deterministic: ranked triangles, no randomness
        "saccot": lambda P, Q, s: register_batch(P, Q, params, impl=impl).T,
    }


def ablation_problems(ratio: float, n_pairs: int, n_corr: int, noise: float, seed: int,
                      device):
    """One cell's problems, the JAX package's: (P, Q [n_pairs, n_corr, 3]
    on `device`, T_gt [n_pairs, 4, 4] NumPy, the per-pair sampler seeds)."""
    probs = [
        correspondence_problem(
            seed=seed + 7919 * i + int(ratio * 1e4),
            n=n_corr, outlier_ratio=ratio, noise=noise,
        )
        for i in range(n_pairs)
    ]
    P = torch.as_tensor(np.stack([p["P"] for p in probs]), device=device)
    Q = torch.as_tensor(np.stack([p["Q"] for p in probs]), device=device)
    return P, Q, np.stack([p["T_gt"] for p in probs]), [seed + i for i in range(n_pairs)]


def run_sampler_ablation(
    params: SacCotParams,
    outlier_ratios: Sequence[float] = (0.8, 0.9, 0.95),
    n_pairs: int = 32,
    n_corr: int = 1000,
    noise: float = 0.004,
    seed: int = 0,
    rot_thresh_deg: float = 5.0,
    trans_thresh: float = 0.05,
    samplers: Sequence[str] = SAMPLERS,
    impl: str = "kernel",
    device="cuda",
) -> Dict:
    """Recall of each sampler at each outlier rate, and per-cell seconds
    (host clock around the cell's call, ending in a sync of the card).

    Returns {"recall": {sampler: {ratio: float}},
             "mean_rot_err_deg": {...}, "secs": {...},
             "budget": params.max_hypotheses, "n_pairs": n_pairs, "n_corr": n_corr}.
    Every sampler sees the same correspondence problems in a cell. The
    problems go to `device` ("cuda" unless the caller asks for "cpu").
    """
    unknown = set(samplers) - set(SAMPLERS)
    if unknown:
        raise ValueError(f"unknown samplers: {sorted(unknown)}")
    dev = torch.device(device)
    fns = _batched_estimators(params, impl)
    recall: Dict[str, Dict[float, float]] = {s: {} for s in samplers}
    rot_err: Dict[str, Dict[float, float]] = {s: {} for s in samplers}
    secs: Dict[str, Dict[float, float]] = {s: {} for s in samplers}

    for ratio in outlier_ratios:
        P_all, Q_all, T_gt, seeds = ablation_problems(ratio, n_pairs, n_corr, noise, seed, dev)

        for s in samplers:
            t0 = time.perf_counter()
            T = fns[s](P_all, Q_all, seeds)
            if T.is_cuda:
                torch.cuda.synchronize(T.device)
            dt = time.perf_counter() - t0
            T_est = T.cpu().numpy().astype(np.float64)
            ok = 0
            errs = []
            for b in range(n_pairs):
                E = T_est[b] @ np.linalg.inv(T_gt[b])
                re = se3np.rotation_angle_deg(E[:3, :3])
                te = float(np.linalg.norm(E[:3, 3]))
                errs.append(re)
                if re < rot_thresh_deg and te < trans_thresh:
                    ok += 1
            recall[s][ratio] = ok / n_pairs
            rot_err[s][ratio] = float(np.mean(errs))
            secs[s][ratio] = dt

    return {
        "recall": recall,
        "mean_rot_err_deg": rot_err,
        "secs": secs,
        "budget": params.max_hypotheses,
        "n_pairs": n_pairs,
        "n_corr": n_corr,
    }


def format_table(result: Dict, metric: str = "recall") -> str:
    """Plain-text paper-style table: samplers x outlier rates."""
    cells = result[metric]
    ratios = sorted(next(iter(cells.values())).keys())
    lines = [
        f"{metric} at K={result['budget']} "
        f"({result['n_pairs']} pairs, N={result['n_corr']})",
        "sampler  " + "  ".join(f"{r:>6.0%}" for r in ratios),
    ]
    for s, row in cells.items():
        lines.append(f"{s:8s}" + "  ".join(f"{row[r]:>6.3f}" for r in ratios))
    return "\n".join(lines)


# The recorded ablation: `saccot_tpu/cli/configs.py` `_OBJ_PARAMS` with
# max_hypotheses set to the budget K, 16 pairs of N=1000 at noise 0.004,
# seed 0, under the 5 deg / 0.05 criterion.
OBJ_PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=256, neighbors_per_anchor=16, max_hypotheses=1024,
)
ABLATION_BUDGETS = (128, 512)
ABLATION_RATIOS = (0.8, 0.9, 0.95)
ABLATION_PAIRS = 16
