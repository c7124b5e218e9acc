"""The comparison that decides `correct`, and the count of failed pairs.

After the window a sample of its pairs, drawn from the seed, is run through
the plain reference (`reference/saccot.py`) on the same inputs, and each
sampled pair's outputs from the window are compared with the reference's.
The sample spans the whole batch: the same number of pairs from each
quarter of it, each from a call of the window drawn at random. The numbers,
each the worst over the sample; a cell compares those its file
(`workloads/<cell>.json`) gives a limit:

- rot_gap_deg: the angle between the window's rotation and the reference's;
- trans_gap: the distance between the translations (configuration units);
- inlier_gap: the difference of the inlier counts;
- score_gap: the difference of the winning hypothesis's score before the
  refine (its inlier count): the largest score in the pool, so it sees the
  degrees, the pool, the solves and the scores that the refine would pull
  to one pose;
- triangle_gap: the difference of the counts of valid pool triangles;
- success_gap: the pairs whose success flags differ.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

NUMBERS = ("rot_gap_deg", "trans_gap", "inlier_gap", "score_gap", "triangle_gap",
           "success_gap")
FIELDS = ("R", "t", "num_inliers", "best_score", "num_valid_triangles", "success")


def draw_sample(seed: int, n_calls: int, pairs_per_call: int,
                sample_pairs: int) -> List[Tuple[int, int]]:
    """(call, pair) positions: sample_pairs / 4 pairs from each quarter of
    the batch (all from one where the batch has fewer than 4 pairs), each
    from a call drawn from the n_calls of the window."""
    rng = np.random.default_rng([seed & (2 ** 63 - 1), 17])
    parts = min(4, pairs_per_call)
    per = max(1, sample_pairs // parts)
    out = []
    for q in range(parts):
        lo, hi = q * pairs_per_call // parts, (q + 1) * pairs_per_call // parts
        for _ in range(per):
            out.append((int(rng.integers(n_calls)), int(lo + rng.integers(hi - lo))))
    return out


def rotation_gap_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle in degrees between rotations [..., 3, 3], from
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2) (exact near 0)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.minimum(1.0, d / (2.0 * np.sqrt(2.0)))))


def gaps(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The compared numbers of `got` against `ref`, each field [S, ...]."""
    def f64(x):
        return np.asarray(x, np.float64)

    return {
        "rot_gap_deg": float(rotation_gap_deg(got["R"], ref["R"]).max()),
        "trans_gap": float(np.linalg.norm(f64(got["t"]) - f64(ref["t"]), axis=-1).max()),
        "inlier_gap": float(np.abs(f64(got["num_inliers"]) - f64(ref["num_inliers"])).max()),
        "score_gap": float(np.abs(f64(got["best_score"]) - f64(ref["best_score"])).max()),
        "triangle_gap": float(np.abs(f64(got["num_valid_triangles"])
                                     - f64(ref["num_valid_triangles"])).max()),
        "success_gap": float((np.asarray(got["success"], bool)
                              != np.asarray(ref["success"], bool)).sum()),
    }


def run_reference(register, P: torch.Tensor, Q: torch.Tensor, mask, prm: Dict,
                  block: int, dtype=torch.float32) -> Dict[str, np.ndarray]:
    """`register` (the reference) over [S, N, 3] inputs in blocks of
    `block` pairs; each field on the host, stacked over the S pairs."""
    outs = []
    for s0 in range(0, P.shape[0], block):
        m = None if mask is None else mask[s0:s0 + block]
        res = register(P[s0:s0 + block], Q[s0:s0 + block], prm, mask=m, dtype=dtype)
        outs.append({f: res[f].float().cpu().numpy() if res[f].is_floating_point()
                     else res[f].cpu().numpy() for f in FIELDS})
        del res
    return {f: np.concatenate([o[f] for o in outs]) for f in FIELDS}


def compared(limits: Dict[str, float]) -> List[str]:
    """The numbers a cell compares: those its file gives a limit."""
    return [k for k in NUMBERS if k in limits]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in compared(limits))


def failed_pairs(calls: Sequence, batches_T: Sequence[np.ndarray],
                 criterion: Dict) -> int:
    """Pairs of the window whose success is false or whose estimate misses
    the configuration's criterion against the planted transform. calls:
    the window's records (`loop.CallRecord`), batches_T: each distinct
    batch's T_gt [B, 4, 4] on the host."""
    failed = 0
    for rec in calls:
        T_gt = batches_T[rec.index % len(batches_T)]
        R = np.asarray(rec.out["R"], np.float64)
        t = np.asarray(rec.out["t"], np.float64)
        Rg, tg = T_gt[:, :3, :3], T_gt[:, :3, 3]
        # E = T_est T_gt^-1: rotation R Rg^T, translation t - R Rg^T tg.
        RE = R @ np.swapaxes(Rg, 1, 2)
        tE = t - np.einsum("bij,bj->bi", RE, tg)
        cos = np.clip((np.trace(RE, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
        rot = np.degrees(np.arccos(cos))
        ok = (np.asarray(rec.out["success"], bool) & (rot < criterion["rot_deg"])
              & (np.linalg.norm(tE, axis=1) < criterion["trans"]))
        failed += int((~ok).sum())
    return failed
