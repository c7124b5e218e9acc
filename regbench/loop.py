"""The closed call loop: one caller, a fixed number of calls in flight.

Call k + 1 is enqueued before call k's results are read back. Right after a
call returns, the copies of its small results to the host are enqueued
behind it (into pinned buffers, without waiting) and an event is recorded;
reading call k back waits on its event alone, so the calls behind it keep
the card busy. A pair counts once its results are on the host.

The loop knows nothing of the estimator: `call(i)` enqueues call i (on
batch i mod the number of batches) and returns its result tensors by
name, and `fields` names those the host reads back.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class CallRecord:
    index: int          # call number; it ran on batch index % batches
    enqueued: float     # host clock before the call
    returned: float     # host clock when the call returned (its enqueue done)
    done: float         # host clock when its results were on the host
    out: Dict[str, np.ndarray]


@dataclasses.dataclass
class Window:
    start: float
    end: float
    calls: List[CallRecord]
    pairs_per_call: int

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def pairs(self) -> int:
        return len(self.calls) * self.pairs_per_call


class _Slot:
    """Host buffers of one call in flight (pinned on a card) and its event."""

    def __init__(self, example: Dict[str, torch.Tensor], fields: Sequence[str]):
        self.cuda = next(iter(example.values())).is_cuda
        self.host = {f: torch.empty(example[f].shape, dtype=example[f].dtype,
                                    pin_memory=self.cuda) for f in fields}
        self.event = torch.cuda.Event() if self.cuda else None

    def enqueue(self, out: Dict[str, torch.Tensor]) -> None:
        for f, buf in self.host.items():
            buf.copy_(out[f], non_blocking=self.cuda)
        if self.cuda:
            self.event.record()

    def read(self) -> Dict[str, np.ndarray]:
        if self.cuda:
            self.event.synchronize()
        return {f: buf.numpy().copy() for f, buf in self.host.items()}


def run_calls(call: Callable[[int], Dict[str, torch.Tensor]], fields: Sequence[str],
              in_flight: int, pairs_per_call: int, seconds: float = None,
              count: int = None, first_index: int = 0, slots: List[_Slot] = None,
              clock=time.perf_counter) -> Window:
    """Enqueue calls while the window is open (`seconds` from the start, or
    `count` calls), keeping `in_flight` of them enqueued and not yet read
    back; then read back the rest. The window ends when the last results
    are on the host. `slots`: a list that keeps the host buffers between
    windows (a warm-up fills it, so the window allocates none)."""
    if (seconds is None) == (count is None):
        raise ValueError("give the window's seconds or its count of calls")
    slots = [] if slots is None else slots
    pending: deque = deque()
    calls: List[CallRecord] = []
    start = clock()
    i = first_index

    def open_() -> bool:
        if count is not None:
            return i - first_index < count
        return clock() - start < seconds

    def read_oldest() -> None:
        idx, t_enq, t_ret, slot = pending.popleft()
        out = slot.read()
        calls.append(CallRecord(idx, t_enq, t_ret, clock(), out))
        slots.append(slot)

    while open_():
        t_enq = clock()
        out = call(i)
        t_ret = clock()
        slot = slots.pop() if slots else _Slot(out, fields)
        slot.enqueue(out)
        del out
        pending.append((i, t_enq, t_ret, slot))
        i += 1
        if len(pending) >= in_flight:
            read_oldest()
    while pending:
        read_oldest()
    return Window(start=start, end=clock(), calls=calls, pairs_per_call=pairs_per_call)
