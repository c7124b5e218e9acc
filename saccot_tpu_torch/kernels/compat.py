"""Compatibility degrees: CUDA kernel wrapper and its plain PyTorch version.

Replaces `saccot_tpu/kernels/compat.py::_degree_kernel_mxu` with
`csrc/compat_degrees.cu`. `degrees` launches the kernel for CUDA tensors and
runs `degrees_reference` (the blocked plain version, `engine/compat.degrees`)
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from saccot_tpu.utils.params import SacCotParams
from saccot_tpu_torch.engine import compat as compat_mod
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import f32_points, optional_mask, ptr, stream_of

degrees_reference = compat_mod.degrees


def degrees(
    P_rows: torch.Tensor,
    Q_rows: torch.Tensor,
    P_cols: torch.Tensor,
    Q_cols: torch.Tensor,
    params: SacCotParams,
    row_offset: int = 0,
    mask_rows: Optional[torch.Tensor] = None,
    mask_cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """deg [batch, R] of rows [batch, R, 3] against columns [batch, C, 3].

    Same contract as `engine.compat.degrees`; `row_offset` is the global index
    of row 0 for the explicit i != j test.
    """
    if not P_rows.is_cuda:
        return degrees_reference(P_rows, Q_rows, P_cols, Q_cols, params,
                                 row_offset=row_offset, mask_rows=mask_rows,
                                 mask_cols=mask_cols)
    batch, R, _ = P_rows.shape
    C = P_cols.shape[1]
    P_rows, Q_rows = f32_points(P_rows, batch, R), f32_points(Q_rows, batch, R)
    P_cols, Q_cols = f32_points(P_cols, batch, C), f32_points(Q_cols, batch, C)
    mask_rows = optional_mask(mask_rows, batch, R, P_rows.device)
    mask_cols = optional_mask(mask_cols, batch, C, P_rows.device)
    deg = torch.empty((batch, R), dtype=torch.float32, device=P_rows.device)
    if batch == 0 or R == 0:
        return deg
    lib = _build.library()
    rc = lib.saccot_compat_degrees(
        ptr(P_rows), ptr(Q_rows), ptr(P_cols), ptr(Q_cols), ptr(mask_rows),
        ptr(mask_cols), ptr(deg), batch, R, C, int(row_offset),
        float(params.compat_tau), float(np.float32(1.0 / params.compat_tau)),
        float(params.min_separation), stream_of(deg),
    )
    _build.check(rc, "compat_degrees")
    _build.LAUNCHES["compat_degrees"] += 1
    return deg
