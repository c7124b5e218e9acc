"""Full-FP32 matrix products.

The JAX package asks for `Precision.HIGHEST` in its Gram products,
covariances, normal equations and pose algebra. On the card a float32
`torch.matmul` runs in TF32 when the process allows it, which keeps about
three decimal digits; these products run in full FP32 whatever that
setting says.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Float32 matrix products in full FP32 (no TF32) inside the block; the
    process-wide flag is put back on exit. It is the flag
    `torch.backends.cuda.matmul.allow_tf32`, which
    `torch.set_float32_matmul_precision` sets too (torch refuses to read
    the flag once a process has mixed it with the newer `fp32_precision`
    settings; the port uses only this one)."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` (batched over leading dims) in full FP32."""
    with full_fp32():
        return a @ b


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` in full FP32 (the JAX package's `_es`, an einsum at
    `Precision.HIGHEST`)."""
    with full_fp32():
        return torch.einsum(eq, *operands)
