"""Profiling helpers: `torch.profiler` traces and per-stage wall timing.

Counterpart of `saccot_tpu/utils/profiling.py`. `trace()` captures a Chrome
trace (Perfetto and `chrome://tracing` open it) around any code region;
`StageTimer` gives cheap named wall timings, waiting for the card where a
stage's results live on it, so device work is charged to its stage.
`profiler()` is the one profiler set-up of the port: `trace()` and
`utils.profile` both capture through it.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict

import torch
from torch.utils._pytree import tree_leaves


# A profiler started in a process that has already run for minutes on the
# H100 (torch 2.11, CUDA 12.8) loses the device records of its first kernel
# launches, however long it waits before them: every capture of `profiler`
# opens with this many launches of `torch.cuda._sleep`'s spin kernel, which
# take those losses before the scope's own work (`chip_smoke.py` phase 14
# (c) prints the whole trace's kernel events against its launch calls).
WARM_UP_LAUNCHES = 128
# The warm-up's kernel: nothing else in the port launches it, so a reader
# of the capture leaves its records out by this name (`is_warm_up`).
WARM_UP_KERNEL = "spin_kernel"


def is_warm_up(name: str) -> bool:
    """Whether a kernel record of a `profiler` capture is the warm-up's."""
    return WARM_UP_KERNEL in name


@contextlib.contextmanager
def profiler():
    """`torch.profiler.profile` over the host and, where there is a card,
    its CUDA activity; yields the profile. On a card the capture opens with
    `WARM_UP_LAUNCHES` launches of the spin kernel in the range
    `profiler/warm_up`, and waits for the card before the profiler stops,
    so the device work launched in the scope is in the capture."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            with torch.profiler.record_function("profiler/warm_up"):
                for _ in range(WARM_UP_LAUNCHES):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `profiler` trace of the scope and write it to a Chrome
    trace file under `logdir` when the scope exits. Yields the path the
    file is written to (also when the scope raises)."""
    path = Path(logdir) / f"trace.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof = None
    try:
        with profiler() as prof:
            yield path
    finally:
        if prof is not None:
            prof.export_chrome_trace(str(path))


def block_until_ready(tree):
    """Wait for the card on each device that holds a tensor of `tree` (a
    tensor, or lists, tuples, named tuples and dicts of them): the
    counterpart of `jax.block_until_ready`. Returns `tree`."""
    devices = {x.device for x in tree_leaves(tree) if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    """Host seconds accumulated per stage name."""

    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the scope under `name`; before reading the clock, wait for
        the card on the devices of the tensors `block_on` holds when the
        scope exits (pass a list or dict the stage fills)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0
