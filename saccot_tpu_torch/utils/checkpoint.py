"""Checkpoint and resume (port of `saccot_tpu/utils/checkpoint.py`).

Two checkpointable states:

1. Sweep progress (`SweepCheckpointer`): which pair shards are done and
   their per-pair results, so a lost process resumes a long dataset sweep
   from the last shard boundary.
2. SLAM state (`save`, `restore`, `save_slam_state`, `restore_slam_state`):
   poses, landmarks and the Gauss-Newton iterate, so BA resumes mid-solve.

A SLAM state is a flat dict of arrays (poses, landmarks, the Gauss-Newton
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


class SweepCheckpointer:
    """Shard-granular progress of a long pairwise sweep.

    One `.npz` per shard in a plain directory, each written to a
    dot-prefixed temporary file and renamed into place: append-only, so a
    crash mid-record loses at most the shard in flight, and a single writer
    (rank 0) needs no coordination. The files are the JAX package's: each
    package resumes from the other's shards.
    """

    def __init__(self, path: Optional[str]):
        self.path = path
        self.done: Dict[int, Dict[str, np.ndarray]] = {}
        if path and os.path.isfile(path):
            # Ignoring a regular file here would discard whatever progress it
            # held and then fail inside os.makedirs at the first record.
            raise ValueError(
                f"sweep checkpoint path {path!r} exists as a regular file; "
                "this checkpointer stores one .npz per shard in a directory. "
                "Remove the file or choose a different --ckpt path."
            )
        if path and os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                # Temporary files of a crash mid-record start with "." and
                # must be skipped, or every resume would fail on them.
                if not (name.startswith("shard_") and name.endswith(".npz")):
                    continue
                stem = name[len("shard_"):-len(".npz")]
                if not stem.isdigit():
                    continue
                with np.load(os.path.join(path, name)) as z:
                    self.done[int(stem)] = {k: z[k] for k in z.files}

    def is_done(self, shard_idx: int) -> bool:
        return shard_idx in self.done

    def record(self, shard_idx: int, results: Dict[str, np.ndarray]) -> None:
        self.done[shard_idx] = {k: np.asarray(v) for k, v in results.items()}
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            final = os.path.join(self.path, f"shard_{shard_idx:06d}.npz")
            # np.savez keeps a name that already ends in .npz as it is.
            tmp = os.path.join(self.path, f".tmp_shard_{shard_idx:06d}.npz")
            np.savez(tmp, **self.done[shard_idx])
            os.replace(tmp, final)

    def merged(self) -> Dict[str, np.ndarray]:
        """Concatenate per-shard results in shard order."""
        out: Dict[str, list] = {}
        for idx in sorted(self.done):
            for k, v in self.done[idx].items():
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}


def save_slam_state(path: str, poses, landmarks=None, gn_iter: int = 0, lam=None) -> None:
    """Checkpoint SLAM state for mid-solve resume: poses, landmarks, the GN
    iterate count and the LM damping `lam`."""
    state = {"poses": poses, "gn_iter": np.asarray(gn_iter)}
    if landmarks is not None:
        state["landmarks"] = landmarks
    if lam is not None:
        state["lam"] = np.asarray(lam)
    save(path, state)


def restore_slam_state(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The SLAM state `save_slam_state` wrote at `path`, or None."""
    return restore(path)
