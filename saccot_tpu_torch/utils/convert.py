"""NumPy <-> torch at the estimator's boundary.

The estimator has no learned weights: its state is the static
`SacCotParams` (shared with the JAX package unchanged) and the
correspondence arrays. Inputs are made with NumPy from a seed
(`saccot_tpu/io/synthetic.py`, which imports no JAX), so both packages get
the identical problems; results come back as NumPy for comparison and for
the registration criteria of `saccot_tpu/evaluation/metrics.py`.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from saccot_tpu.evaluation.metrics import registration_recall
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu_torch.engine.sac_cot import RegistrationResult


def to_torch(*arrays: np.ndarray, device="cpu") -> Tuple[torch.Tensor, ...]:
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


def problem_batch(seeds: Iterable[int], device="cpu", **kwargs):
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
