"""Ring-scheduled compatibility degrees over a correspondence-sharded group.

Port of `saccot_tpu/dist/ring.py::degrees_ring` and the schedule of
`saccot_tpu/kernels/ring_compat.py::_ring_degree_kernel`: at step s, rank r
holds the column block first owned by rank (r - s) mod d, scores its local
rows against it (`kernels/ring_compat.ring_degrees_step`), and forwards the
block to rank (r + 1) mod d. No rank ever holds more than two column blocks,
and nothing quadratic is formed.

Two packed buffers alternate. Step s posts the send of `buf[slot]` and the
receive into `buf[1 - slot]` (`dist/collectives.ring_shift`) before it
launches its kernel on `buf[slot]`, and waits on the hop before step s + 1
reads `buf[1 - slot]`. The stream order of the hop stands in for the TPU's
`free_sem` handshake: a receive is queued after the kernel that last read
its buffer.
"""

from __future__ import annotations

from typing import Optional

import torch

from saccot_tpu_torch.dist.collectives import group_rank, group_size, ring_shift
from saccot_tpu_torch.kernels import ring_compat as ring_k
from saccot_tpu_torch.utils.params import SacCotParams


def degrees_ring(
    P_loc: torch.Tensor,
    Q_loc: torch.Tensor,
    params: SacCotParams,
    group,
    mask_loc: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Weighted degrees [batch, n_loc] of the local rows P_loc, Q_loc
    [batch, n_loc, 3] (mask_loc [batch, n_loc]) against every rank's block.

    Every rank of `group` holds n_loc correspondences, rank r the global ids
    r * n_loc ... (r + 1) * n_loc - 1. `impl="kernel"` runs the ring step
    through its wrapper (the CUDA kernel on a card, the plain version on the
    CPU); `impl="plain"` runs the plain step on any device. Equal to the
    all-gather route up to the f32 summation order.
    """
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    step = ring_k.ring_degrees_step if impl == "kernel" else ring_k.ring_degrees_step_reference
    d, r = group_size(group), group_rank(group)
    batch, n_loc, _ = P_loc.shape
    blk = ring_k.pack_block(P_loc, Q_loc, mask_loc)
    deg = torch.zeros((batch, n_loc), dtype=torch.float32, device=P_loc.device)
    row_base = r * n_loc
    if d == 1:
        return step(blk, blk, deg, row_base, row_base, params)
    buf = [blk.clone(), torch.empty_like(blk)]
    for s in range(d):
        slot = s % 2
        hop = ring_shift(buf[slot], buf[1 - slot], group) if s + 1 < d else None
        step(blk, buf[slot], deg, row_base, ((r - s) % d) * n_loc, params)
        if hop is not None:
            hop.wait()
    return deg
