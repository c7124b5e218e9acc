"""External (learned) descriptors from `.npz` files, the FCGF-style path.

Port of `saccot_tpu/io/external.py`: archives with keys `xyz` [N, 3] and
`desc` [N, D]; `correspondences_from_descriptors` matches two sets
(`match/topk.py`) into the padded, masked correspondence arrays the
estimator takes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from saccot_tpu_torch.match.topk import match_descriptors, mutual_filter


def load_descriptors_npz(path: str) -> Dict[str, np.ndarray]:
    """Load {xyz [N,3], desc [N,D]} from an .npz archive."""
    with np.load(path) as z:
        xyz = np.asarray(z["xyz"], np.float32)
        desc = np.asarray(z["desc"], np.float32)
    if xyz.shape[0] != desc.shape[0]:
        raise ValueError(f"{path}: xyz/desc row mismatch {xyz.shape} vs {desc.shape}")
    return dict(xyz=xyz, desc=desc)


def save_descriptors_npz(path: str, xyz: np.ndarray, desc: np.ndarray) -> None:
    np.savez_compressed(path, xyz=np.asarray(xyz, np.float32), desc=np.asarray(desc, np.float32))


def correspondences_from_descriptors(
    src: Dict[str, np.ndarray],
    tgt: Dict[str, np.ndarray],
    max_correspondences: int = 2048,
    mutual: bool = True,
    ratio_test: float = 0.0,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, Q, mask) correspondence tensors on `device` from two descriptor
    sets: descriptor-space matching, then the best `max_correspondences`."""
    ds = torch.as_tensor(src["desc"], device=device)
    dt = torch.as_tensor(tgt["desc"], device=device)
    m = mutual_filter(match_descriptors(ds, dt, mutual=mutual, ratio_test=ratio_test),
                      max_correspondences)
    P = torch.as_tensor(src["xyz"], device=device)[m.src_idx]
    Q = torch.as_tensor(tgt["xyz"], device=device)[m.tgt_idx]
    return P, Q, m.valid.to(torch.float32)
