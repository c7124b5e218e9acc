"""Structured JSONL logging and rank-0 gating (port of
`saccot_tpu/utils/logging.py`).

Every pair or sequence result is one JSON record that tooling can read back;
in a multi-process group only rank 0 writes. Values that JSON cannot hold
are written as lists (arrays, tensors) or numbers (NumPy scalars).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional, TextIO

import torch
import torch.distributed as dist


def is_host0() -> bool:
    """True on rank 0 of the default group, and in a process that joined none."""
    return dist.get_rank() == 0 if dist.is_initialized() else True


class JsonlLogger:
    """Append-only JSONL sink; silently no-ops on non-zero ranks."""

    def __init__(self, path: Optional[str] = None, stream: Optional[TextIO] = None):
        self._enabled = is_host0()
        self._fh: Optional[TextIO] = None
        if not self._enabled:
            return
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = stream or sys.stderr

    def log(self, record: Dict[str, Any]) -> None:
        if not self._enabled or self._fh is None:
            return
        record = dict(record)
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record, default=_np_default) + "\n")

    def close(self) -> None:
        if self._fh is not None and self._fh not in (sys.stderr, sys.stdout):
            self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _np_default(o):
    import numpy as np

    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
