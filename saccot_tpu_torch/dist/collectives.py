"""The collectives of the sharded estimator, over `torch.distributed` groups.

The JAX package `vmap`s inside each shard and uses `lax.all_gather`,
`lax.psum` and `ppermute`; the port carries the batch axis explicitly
(`[b_loc, n_loc, ...]`), so these helpers gather and reduce with the batch
axis in place. `group=None` means "not sharded": every helper then returns
its input unchanged, and no call reaches `torch.distributed`.

Transport: NCCL carries CUDA tensors. gloo takes CUDA tensors in
all_reduce and all_gather (and all_gather_into_tensor), as `chip_smoke.py`
phase 9 found on an H100, but its point-to-point send/recv hands the
tensor's raw pointer to its TCP transport: on a gloo group the ring hop of
a CUDA block goes through pinned host memory. The engine never asks which
backend it runs on. Results are the same on every rank of a group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Bool tensors travel as uint8 (not every backend reduces or gathers bool)."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Tiled all-gather: every rank's `x` concatenated along `dim` in group
    rank order (`lax.all_gather(..., tiled=True)`)."""
    d = group_size(group)
    if d == 1:
        return x
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(d)]
    dist.all_gather(parts, w, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (`lax.psum`), as a new tensor."""
    if group_size(group) == 1:
        return x
    w = _wire(x).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(torch.bool) if x.dtype == torch.bool else w


class _Shift:
    """A posted ring hop; `wait` completes it (and copies a staged receive
    onto the card, ordered on the current stream)."""

    def __init__(self, works, host_recv=None, recv=None):
        self._works, self._host_recv, self._recv = works, host_recv, recv

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        if self._host_recv is not None:
            self._recv.copy_(self._host_recv, non_blocking=True)


def ring_shift(send: torch.Tensor, recv: torch.Tensor, group) -> _Shift:
    """Post the send of `send` to the right neighbour (group rank r + 1) and
    the receive of the left neighbour's block into `recv`, both at once;
    `wait()` on the result before reading `recv` or writing `send`.

    NCCL runs both on its own stream after the work already queued on the
    current stream, so a receive never overtakes the kernel that last read
    its buffer. A staged (gloo, CUDA) hop copies `send` to the host first,
    which waits for that work too.
    """
    d, r = group_size(group), group_rank(group)
    right = dist.get_global_rank(group, (r + 1) % d)
    left = dist.get_global_rank(group, (r - 1) % d)
    host_recv = None
    if send.is_cuda and dist.get_backend(group) == "gloo":
        send = send.cpu()
        host_recv = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, right, group),
        dist.P2POp(dist.irecv, recv if host_recv is None else host_recv, left, group),
    ])
    return _Shift(works, host_recv, recv if host_recv is not None else None)
