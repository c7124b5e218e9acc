"""Argument checks and launch helpers shared by the kernel wrappers (CUDA
tensors only)."""

from __future__ import annotations

from typing import Optional

import torch


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")


def f32_tensor(x: torch.Tensor, shape: tuple, name: str) -> torch.Tensor:
    """A contiguous float32 CUDA tensor of the given shape, or raise."""
    _require_cuda(x, name)
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    return x.contiguous()


def f32_points(x: torch.Tensor, batch: int, n: int, name: str = "points") -> torch.Tensor:
    """A contiguous float32 [batch, n, 3] CUDA tensor, or raise."""
    return f32_tensor(x, (batch, n, 3), name)


def index_tensor(x: torch.Tensor, shape: tuple, name: str) -> torch.Tensor:
    """A contiguous int64 CUDA tensor of the given shape, or raise."""
    _require_cuda(x, name)
    if x.dtype != torch.int64:
        raise TypeError(f"{name} must be int64, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    return x.contiguous()


def optional_mask(m: Optional[torch.Tensor], batch: int, n: int,
                  device: torch.device) -> Optional[torch.Tensor]:
    """None, or a contiguous float32 [batch, n] mask on `device`."""
    if m is None:
        return None
    _require_cuda(m, "mask")
    if m.device != device:
        raise ValueError(f"mask on {m.device}, points on {device}")
    if tuple(m.shape) != (batch, n):
        raise ValueError(f"mask must have shape {(batch, n)}, got {tuple(m.shape)}")
    return m.to(torch.float32).contiguous()


def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# The tickets of the launches that combine their splits in the last block
# (csrc/score.cu, the two-sided loop of csrc/degree_loops.cuh,
# csrc/anchor_topb_stream.cu, which keeps its per-anchor floors after its
# tickets, and the passes of csrc/refine.cu), one buffer per (device,
# stream): each launch leaves every ticket it takes at 0, so the buffer is
# zeroed once, when it is made or outgrown, and launches on one stream,
# which run in turn, share it.
_TICKETS: dict = {}


def tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 tickets for a launch on `stream`."""
    buf = _TICKETS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _TICKETS[(dev, stream)] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf
