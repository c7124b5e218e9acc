"""Batched 3-point rigid solves: CUDA kernel wrapper and its plain version.

Replaces `saccot_tpu/kernels/solve3.py::_solve_kernel` — and the Horn
iteration and rotation assembly the TPU ran in XLA after it — with
`csrc/solve3.cu`. Output is the SoA layout the scoring kernel reads:
rotations `r9 [batch, 9, K]` (row-major entries), translations
`t3 [batch, 3, K]`. The direct-index loads cover any N. `solve_plan`
chooses the threads a block (one thread a hypothesis); every plan gives the
same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from saccot_tpu_torch.engine.svd3 import (
    quaternion_from_cross_covariance,
    rotation_entries_from_quaternion,
)
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import (
    f32_points, index_tensor, ptr, sm_count, stream_of,
)
from saccot_tpu_torch.utils import debug

MAX_THREADS = 256    # threads a block (the kernel's launch bound)
# Blocks of THREADS wherever they cover the card's SMs, of MID_THREADS where
# only those do, of FEW_THREADS where neither does (the kitti point's
# 2 x 2,048 hypotheses make 16 blocks of 256 and 32 of 128). Measured on an
# H100 over {32, 64, 128, 256} (`scripts/exp_small_kernels.py`; PERF.md §6):
# at the bench point (128 x 1,024) blocks of 256 read 0.00854 ms and blocks
# of 128 0.00879 (medians of 10 pairs each), at the 3DMatch point (32 x
# 2,048) 0.00544 and 0.00553; at kitti blocks of 64 read 0.0028 and of 256
# 0.0040.
THREADS = 256
MID_THREADS = 128
FEW_THREADS = 64


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Grid of the solve kernel: (tiles, batch) blocks of `threads`
    threads, one a hypothesis."""
    batch: int
    threads: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.batch


def make_solve_plan(batch: int, K: int, threads: int) -> SolvePlan:
    """The grid of `batch` x K hypotheses in blocks of `threads`."""
    return SolvePlan(batch=batch, threads=threads, tiles=-(-K // threads))


def solve_plan(batch: int, K: int, sms: int) -> SolvePlan:
    """The solve kernel's grid for `batch` x K hypotheses on a card of `sms`
    SMs: the largest blocks of THREADS and MID_THREADS that cover the SMs,
    else blocks of FEW_THREADS."""
    for threads in (THREADS, MID_THREADS):
        plan = make_solve_plan(batch, K, threads)
        if plan.blocks >= sms:
            return plan
    return make_solve_plan(batch, K, FEW_THREADS)


def solve3_reference(
    P: torch.Tensor, Q: torch.Tensor, triples: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, in the kernel's order of operations.

    P, Q [batch, N, 3]; triples [batch, K, 3] int64 -> r9, t3.
    """
    batch, K, _ = triples.shape
    flat = triples.reshape(batch, K * 3, 1).expand(batch, K * 3, 3)
    p = torch.gather(P, 1, flat).reshape(batch, K, 3, 3)    # [batch, K, slot, xyz]
    q = torch.gather(Q, 1, flat).reshape(batch, K, 3, 3)
    third = 1.0 / 3.0
    pbar = (p[:, :, 0] + p[:, :, 1] + p[:, :, 2]) * third    # [batch, K, 3]
    qbar = (q[:, :, 0] + q[:, :, 1] + q[:, :, 2]) * third
    pc = p - pbar[:, :, None]
    qc = q - qbar[:, :, None]
    H = [pc[:, :, 0, a] * qc[:, :, 0, c] + pc[:, :, 1, a] * qc[:, :, 1, c]
         + pc[:, :, 2, a] * qc[:, :, 2, c] for a in range(3) for c in range(3)]
    r = rotation_entries_from_quaternion(*quaternion_from_cross_covariance(*H))
    r9 = torch.stack(r, dim=1)                                 # [batch, 9, K]
    t3 = torch.stack(
        [qbar[..., c] - (r[3 * c] * pbar[..., 0] + r[3 * c + 1] * pbar[..., 1]
                         + r[3 * c + 2] * pbar[..., 2]) for c in range(3)],
        dim=1,
    )                                                          # [batch, 3, K]
    return r9, t3


def solve3(
    P: torch.Tensor, Q: torch.Tensor, triples: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid transform of each triple: (P, Q [batch, N, 3], triples
    [batch, K, 3] int64) -> (r9 [batch, 9, K], t3 [batch, 3, K])."""
    if not P.is_cuda:
        return solve3_reference(P, Q, triples)
    batch, K = triples.shape[:2]
    return _solve(P, Q, triples, solve_plan(batch, K, sm_count(P.device)))


def _solve(P, Q, triples, plan: SolvePlan):
    """Launch `csrc/solve3.cu` on the grid of `plan` (any plan of the shape
    gives the same bits)."""
    batch, N, _ = P.shape
    K = triples.shape[1]
    if (plan != make_solve_plan(batch, K, plan.threads) or plan.threads % 32
            or not 32 <= plan.threads <= MAX_THREADS):
        raise ValueError(f"{plan} is no grid of {batch} x {K} hypotheses")
    if max(3 * N, 9 * K) >= 2 ** 31:
        raise ValueError(f"{batch} x {K} hypotheses over N={N} points overflow the "
                         "kernel's 32-bit indices")
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    triples = index_tensor(triples, (batch, K, 3), "triples")
    r9 = torch.empty((batch, 9, K), dtype=torch.float32, device=P.device)
    t3 = torch.empty((batch, 3, K), dtype=torch.float32, device=P.device)
    if batch == 0 or K == 0:
        return r9, t3
    lib = _build.library()
    rc = lib.saccot_solve3(ptr(P), ptr(Q), ptr(triples), ptr(r9), ptr(t3),
                           batch, N, K, plan.threads, stream_of(r9))
    _build.check(rc, "solve3")
    _build.LAUNCHES["solve3"] += 1
    debug.check_kernel("solve3", r9, t3)
    return r9, t3
