"""Process-group setup and the ("pairs", "hyp", "corr") device mesh.

Port of `saccot_tpu/dist/mesh.py`. The mesh's axes carry the estimator's
three parallelism dimensions, in the JAX package's layout order:

  "pairs": data parallelism over independent scan pairs (the sweep axis),
  "hyp":   the hypothesis pool sharded over ranks (TP),
  "corr":  the correspondence axis of one registration problem (SP),
           innermost, so the latency-bound collectives of one problem join
           neighbouring ranks.

The mesh is a `torch.distributed.device_mesh.DeviceMesh`; each axis's
process group (`mesh.get_group(name)`) carries that axis's collectives. A
single process that joined no group (no `WORLD_SIZE`, or 1) gets a
`SingleRankMesh` instead, every axis of size 1, as the JAX package's mesh
over one device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = ("pairs", "hyp", "corr")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> Optional[str]:
    """Join the process group and return its backend.

    The rendezvous is `tcp://<coordinator_address>` ("host:port"), the world
    size `num_processes` and this process's rank `process_id`, as the JAX
    package's arguments name them. Each one not given is read from the
    `env://` variables (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK
    and LOCAL_WORLD_SIZE default to the rank and the world size). A single
    process (a world size unset or 1) joins nothing and returns None.

    backend=None picks NCCL when every rank of this host has a card of its
    own (rank LOCAL_RANK takes card LOCAL_RANK), else gloo: CPU tensors, or
    one card shared by several ranks (rank-to-card as `torch.cuda`'s
    current device says).
    """
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None else num_processes
    if world <= 1:
        return None
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if cards >= local_world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    init_method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return backend


class SingleRankMesh:
    """The mesh of a process that joined no group: every axis of size 1,
    this process at 0 on each. It answers the calls `axis_size`,
    `axis_group` and the sweep make of a `DeviceMesh`."""

    def size(self, dim: Optional[int] = None) -> int:
        return 1

    def get_local_rank(self, name: str) -> int:
        return 0


def make_mesh(pairs: int = 0, corr: int = 1, hyp: int = 1):
    """A (pairs, hyp, corr) mesh over every rank of the default group.

    pairs=0 means "all remaining ranks on the pairs axis". Rank r sits at
    (r // (hyp * corr), r // corr % hyp, r % corr). Every rank must call it,
    in the same order as its other group creations. With no group (one
    process, see `init_distributed`) it is a `SingleRankMesh`.
    """
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError("WORLD_SIZE > 1: call init_distributed() before make_mesh()")
    n = dist.get_world_size() if dist.is_initialized() else 1
    inner = corr * hyp
    if corr < 1 or hyp < 1 or n % inner:
        raise ValueError(f"corr*hyp={inner} must divide the world size {n}")
    if pairs == 0:
        pairs = n // inner
    if pairs * inner != n:
        raise ValueError(f"mesh {pairs}x{hyp}x{corr} does not cover the {n} ranks")
    if not dist.is_initialized():
        return SingleRankMesh()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (pairs, hyp, corr), mesh_dim_names=AXES)


def axis_size(mesh, name: str) -> int:
    return mesh.size(AXES.index(name))


def axis_group(mesh, name: str):
    """The process group of one mesh axis, or None when the axis has size 1
    (nothing is sharded over it)."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


def local_batch_size(total: int, mesh, axis: str = "pairs") -> int:
    size = axis_size(mesh, axis)
    if total % size:
        raise ValueError(f"batch {total} not divisible by mesh axis {axis}={size}")
    return total // size
