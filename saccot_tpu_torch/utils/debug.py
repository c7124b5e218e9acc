"""Debug guards: raise on the first NaN an op or a kernel writes in a scope.

Counterpart of `saccot_tpu/utils/debug.py`, whose `nan_guard()` turns on
`jax_debug_nans` for a scope. The port runs op by op, so its guard checks
what JAX checks outside `jit`: the output of every operation.

- Tensor ops: a `TorchDispatchMode` sees each aten op and tests its
  floating outputs. PyTorch calls `__torch_dispatch__` with the mode taken
  off the stack, so the test's own ops (`isnan`, `any`, `item`) do not
  dispatch into it again. Uninitialised buffers (`empty` and its kin) may
  hold NaN bits that no op wrote: JAX has no such buffers, and their
  outputs are not tested; nor is data taken in (`torch.from_numpy`), as
  JAX does not test `jnp.asarray`. A copy, a cast or a move to another
  device of data that holds a NaN is an op that writes it.
- The CUDA kernels: they are launched through `ctypes`, which no dispatch
  sees, so each kernel wrapper calls `check_kernel` on its outputs right
  after its launch. While no guard is on that is one flag test: no test of
  the data, no sync with the card.

Data races are impossible in the ops' functional model and the kernels sum
in fixed orders (no atomics), so what remains worth guarding is NaN
propagation through branchless masked math, and seed discipline: tests and
scripts seed NumPy generators and torch throughout.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
# Ops that write no values of their own: uninitialised buffers (whatever the
# allocator left there) and the caller's data taken in (`torch.tensor`,
# `torch.from_numpy`), as `jnp.asarray` is not checked either.
_UNCHECKED = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
              _aten.new_empty_strided, _aten.lift, _aten.lift_fresh, _aten.lift_fresh_copy}
_TORCH_DIR = str(Path(torch.__file__).resolve().parent)

_enabled = False


def _has_nan(out) -> bool:
    return any(isinstance(x, torch.Tensor) and x.device.type != "meta"
               and (x.is_floating_point() or x.is_complex()) and bool(torch.isnan(x).any())
               for x in tree_leaves(out))


def _caller() -> str:
    """The innermost frame outside torch and this module: the line of the
    port (or of its caller) that ran the op."""
    frame = sys._getframe(1)
    while frame is not None:
        f = frame.f_code.co_filename
        if f != __file__ and not f.startswith(_TORCH_DIR):
            return f"{frame.f_code.co_name} ({f}:{frame.f_lineno})"
        frame = frame.f_back
    return "?"


class _NanMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _enabled and func.overloadpacket not in _UNCHECKED and _has_nan(out):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {func}, called from {_caller()}")
        return out


def check_kernel(name: str, *outputs: torch.Tensor) -> None:
    """Raise FloatingPointError, naming kernel `name`, if a guard is on and
    one of the kernel's outputs holds a NaN. Kernel wrappers call it right
    after their launch; with no guard on it only tests a flag."""
    if _enabled and _has_nan(outputs):
        raise FloatingPointError(f"invalid value (nan) encountered in kernel {name}, "
                                 f"called from {_caller()}")


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Raise FloatingPointError on any NaN an op or a kernel writes inside
    the scope; `enable=False` turns an outer guard off for the scope. The
    previous state comes back when the scope exits."""
    global _enabled
    prev = _enabled
    _enabled = enable
    try:
        if enable and not prev:
            with _NanMode():
                yield
        else:
            yield
    finally:
        _enabled = prev
