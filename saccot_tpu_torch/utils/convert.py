"""NumPy <-> torch at the estimator's boundary.

The estimator has no learned weights: its state is the static
`SacCotParams` (`utils/params.py`, the JAX package's fields and defaults)
and the correspondence arrays. Inputs are made with NumPy from a seed
(`io/synthetic.py`, which gives the JAX package's arrays bit for bit), so
both packages get the identical problems; results come back as NumPy for
comparison and for the registration criteria of `evaluation/metrics.py`.
Tensors land on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from saccot_tpu_torch.engine.sac_cot import RegistrationResult
from saccot_tpu_torch.evaluation.metrics import registration_recall
from saccot_tpu_torch.io.synthetic import correspondence_problem
from saccot_tpu_torch.utils.params import SacCotParams

# The kitti run configuration (`saccot_tpu/cli/configs.py`, "kitti"; that
# module imports JAX, so its values are restated here and a test holds them
# equal): LiDAR-scale pairs, N = 50,000 correspondences, 70% outliers.
KITTI_PARAMS = SacCotParams(
    compat_tau=0.3, min_separation=1.0, inlier_tau=0.3,
    num_anchors=512, neighbors_per_anchor=16, max_hypotheses=2048,
    degree_block_rows=512,
)
KITTI_SEED = 500
KITTI_CRITERION = (5.0, 0.6)   # rotation degrees, translation metres


def to_torch(*arrays: np.ndarray, device="cuda") -> Tuple[torch.Tensor, ...]:
    """NumPy arrays -> tensors on `device` (float arrays as float32)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        out.append(torch.as_tensor(a, device=device))
    return tuple(out)


def result_to_numpy(res: RegistrationResult) -> RegistrationResult:
    """Every field of a result as a NumPy array on the host."""
    return RegistrationResult(*(x.detach().cpu().numpy() for x in res))


def problem_batch(seeds: Iterable[int], device="cuda", **kwargs):
    """Planted problems `correspondence_problem(seed=s, **kwargs)` stacked:
    returns (P [batch, N, 3], Q [batch, N, 3]) on `device` and T_gt
    [batch, 4, 4] as NumPy float64."""
    probs = [correspondence_problem(seed=s, **kwargs) for s in seeds]
    P, Q = to_torch(np.stack([p["P"] for p in probs]),
                    np.stack([p["Q"] for p in probs]), device=device)
    return P, Q, np.stack([p["T_gt"] for p in probs])


def recall(res: RegistrationResult, T_gt: np.ndarray, rot_thresh_deg: float,
           trans_thresh: float) -> float:
    """Fraction of the batch registered within the rotation/translation criterion."""
    T = res.T.detach().cpu().numpy().astype(np.float64)
    return registration_recall(zip(T, T_gt), rot_thresh_deg, trans_thresh)


def kitti_problem_batch(seeds: Iterable[int], device="cuda", n: int = 50000):
    """The kitti configuration's problems, as `run_kitti_config`
    (`saccot_tpu/cli/runners.py`) makes them: 70% outliers, unit-blob
    problems with noise 0.05 / 30, n_points = 4 n, rotations up to 0.3 rad
    and translations up to 3, then coordinates and the T_gt translation
    scaled by 30 (scene-scale spread, metric noise). Returns (P, Q)
    [batch, n, 3] on `device` and T_gt [batch, 4, 4] NumPy float64."""
    scale = 30.0
    probs = [correspondence_problem(seed=s, n=n, outlier_ratio=0.7, noise=0.05 / scale,
                                    n_points=4 * n, max_angle=0.3, max_trans=3.0)
             for s in seeds]
    T_gt = np.stack([p["T_gt"] for p in probs])
    T_gt[:, :3, 3] *= scale
    P, Q = to_torch(np.stack([p["P"] * scale for p in probs]),
                    np.stack([p["Q"] * scale for p in probs]), device=device)
    return P, Q, T_gt
