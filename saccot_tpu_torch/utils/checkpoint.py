"""Checkpoint and resume of the SLAM state (port of the SLAM-state half of
`saccot_tpu/utils/checkpoint.py`).

A state is a flat dict of arrays (poses, landmarks, the Gauss-Newton
iterate count, the LM damping). `save` writes it with `torch.save` as CPU
tensors to a temporary file beside `path` and renames it into place, so a
crash mid-write leaves the previous checkpoint whole; `restore` reads it
back (`weights_only` loading) as NumPy arrays. Restoring the damping is
what makes a resumed bundle adjustment follow the uninterrupted run's
accept/reject schedule (`slam/frontend.run_sequence`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _cpu(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def save(path: str, state: Dict[str, Any]) -> None:
    """Save a flat dict of arrays or tensors (overwrites)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path), f".tmp_{os.path.basename(path)}")
    with open(tmp, "wb") as f:
        torch.save({k: _cpu(v) for k, v in state.items()}, f)
    os.replace(tmp, path)


def restore(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The state saved at `path` as NumPy arrays, or None if there is none."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items()}


def save_slam_state(path: str, poses, landmarks=None, gn_iter: int = 0, lam=None) -> None:
    """Checkpoint SLAM state for mid-solve resume: poses, landmarks, the GN
    iterate count and the LM damping `lam`."""
    state = {"poses": poses, "gn_iter": np.asarray(gn_iter)}
    if landmarks is not None:
        state["landmarks"] = landmarks
    if lam is not None:
        state["lam"] = np.asarray(lam)
    save(path, state)
