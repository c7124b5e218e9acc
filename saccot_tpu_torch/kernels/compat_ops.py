"""Timing variants of the degree kernels' pair loop: CUDA wrapper and plain
PyTorch version.

Replaces `scripts/exp_compat_ops.py::variant_kernel`, the TPU script's
per-operation attribution of its N=50,000 degree kernel, by
`csrc/compat_ops.cu`. Five modes strip the pair loop down to a prefix of
its operations (the script's names; per pair, each operation rounded on its
own):

  gram_only     p_i.p_j + q_i.q_j
  d2_only       dp2 + dq2 (squared distances, no roots)
  one_sqrt      sqrt(dp2) + dq2
  no_sqrt_tail  (min(dp2, dq2) > min_sep^2) ? max(1 - |dp2 - dq2| / tau^2, 0) : 0
  full          the compatibility score of `engine.compat.pair_score`

and `variant_degrees` returns each row's sum over all N columns (the self
pair included). Only `full` is a degree: it equals `compat.degrees` on
unmasked input bit for bit, since a self pair fails min(dp, dq) > min_sep.
The others are timing aids, never part of `register_batch`.

The two forms are the production kernels' two loops
(`csrc/degree_loops.cuh`): "two_sided" (`compat_degrees.cu`'s, on the grid
of `kernels/compat.degree_plan`) and "tri"
(`compat_degrees_tri.cu`'s: each unordered tile pair once, row and column
sums). The plain version mirrors the form: row blocks for
"two_sided"; for "tri", upper-triangle tile pairs whose row sums and column
sums are summed per tile, then over tiles in order. For CUDA tensors
`variant_degrees` launches the kernel; for CPU tensors it runs the plain
version. It never falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from saccot_tpu_torch.engine.compat import _BLOCK_ELEMS, cross_sq_distances, pair_score
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels._common import f32_points, ptr, sm_count, stream_of
from saccot_tpu_torch.kernels.compat import degree_plan, split_scratch
from saccot_tpu_torch.utils.params import SacCotParams

MODES = ("gram_only", "d2_only", "one_sqrt", "no_sqrt_tail", "full")
FORMS = ("tri", "two_sided")
_TILE = 128          # tile edge of the tri form in csrc/compat_ops.cu
_PLAIN_TILE = 512    # tile edge of the plain tri form


def _check(mode: str, form: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")


def _consts(params: SacCotParams):
    """(tau, 1/tau, min_sep, 1/tau^2, min_sep^2) as float32 values, each
    rounded once from double as the TPU script's Python scalars are."""
    tau, sep = params.compat_tau, params.min_separation
    return tuple(float(np.float32(x)) for x in
                 (tau, 1.0 / tau, sep, 1.0 / (tau * tau), sep * sep))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., R, 3] x [..., C, 3] -> ((ax*bx + ay*by) + az*bz) [..., R, C]."""
    return (a[..., :, None, 0] * b[..., None, :, 0] + a[..., :, None, 1] * b[..., None, :, 1]
            + a[..., :, None, 2] * b[..., None, :, 2])


def _pair_values(P_rows, Q_rows, P_cols, Q_cols, params: SacCotParams, mode: str):
    """The value each pair adds to its row sum in `mode`: [batch, R, C]."""
    *_, inv_tau2, sep2 = _consts(params)
    if mode == "gram_only":
        return _dot(P_rows, P_cols) + _dot(Q_rows, Q_cols)
    dp2, dq2 = cross_sq_distances(P_rows, P_cols), cross_sq_distances(Q_rows, Q_cols)
    if mode == "d2_only":
        return dp2 + dq2
    if mode == "one_sqrt":
        return torch.sqrt(dp2) + dq2
    if mode == "no_sqrt_tail":
        s = torch.clamp_min(1.0 - torch.abs(dp2 - dq2) * inv_tau2, 0.0)
        return torch.where(torch.minimum(dp2, dq2) > sep2, s, 0.0)
    return pair_score(torch.sqrt(dp2), torch.sqrt(dq2), params.compat_tau, params.min_separation)


def variant_degrees_reference(P: torch.Tensor, Q: torch.Tensor, params: SacCotParams,
                              mode: str, form: str = "tri") -> torch.Tensor:
    """Row sums [batch, N] of `mode`'s pair values over all N columns, in the
    decomposition of `form`: row blocks, or upper-triangle tile pairs of
    edge `_PLAIN_TILE` (each pair's values go to its row and, off the
    diagonal, to its column), with the per-tile partial sums added in tile
    order."""
    _check(mode, form)
    batch, N, _ = P.shape
    if form == "two_sided":
        rows = max(1, min(N, _BLOCK_ELEMS // max(1, batch * N)))
        out = [_pair_values(P[:, r:r + rows], Q[:, r:r + rows], P, Q, params, mode).sum(-1)
               for r in range(0, N, rows)]
        return torch.cat(out, dim=1) if out else P.new_zeros((batch, 0))
    edges = list(range(0, N, _PLAIN_TILE))
    part = P.new_zeros((len(edges), batch, N))
    for tj, c0 in enumerate(edges):
        cs = slice(c0, c0 + _PLAIN_TILE)
        for ti, r0 in enumerate(edges[:tj + 1]):
            rs = slice(r0, r0 + _PLAIN_TILE)
            v = _pair_values(P[:, rs], Q[:, rs], P[:, cs], Q[:, cs], params, mode)
            part[tj, :, rs] = v.sum(-1)
            if ti != tj:
                part[ti, :, cs] = v.sum(-2)
    deg = P.new_zeros((batch, N))
    for t in range(len(edges)):
        deg = deg + part[t]
    return deg


def variant_degrees(P: torch.Tensor, Q: torch.Tensor, params: SacCotParams, mode: str,
                    form: str = "tri") -> torch.Tensor:
    """Row sums [batch, N] of `mode`'s pair values of P, Q [batch, N, 3]
    through `csrc/compat_ops.cu` in `form`; the plain version on CPU tensors."""
    _check(mode, form)
    if not P.is_cuda:
        return variant_degrees_reference(P, Q, params, mode, form)
    batch, N, _ = P.shape
    P, Q = f32_points(P, batch, N, "P"), f32_points(Q, batch, N, "Q")
    deg = torch.empty((batch, N), dtype=torch.float32, device=P.device)
    if batch == 0 or N == 0:
        return deg
    n_tiles = -(-N // _TILE)
    stream = stream_of(deg)
    plan = degree_plan(batch, N, N, sm_count(P.device))
    ticket_buf = None
    if form == "tri":
        if n_tiles * (n_tiles + 1) // 2 >= 2 ** 31:
            raise ValueError(f"the tri form takes N <= {_TILE * 65535} (got {N})")
        part = torch.empty((batch, n_tiles, N), dtype=torch.float32, device=P.device)
    else:
        part, ticket_buf = split_scratch(plan, N, P.device, stream)
    counter = f"compat_ops_{form}"
    rc = _build.library().saccot_compat_ops(
        ptr(P), ptr(Q), ptr(part), ptr(deg), batch, N, n_tiles, MODES.index(mode),
        int(form == "tri"), *_consts(params), plan.rows, plan.splits, ptr(ticket_buf), stream,
    )
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    return deg
