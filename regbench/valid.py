"""The valid correspondences of the traced calls, as the program counts them,
and the shares of the rooflines of the work they need.

A masked call of the program's `register_batch` records each pair's valid
count, `mask.sum(1)`, in its bounded store `VALID_COUNTS`
(`saccot_tpu_torch/engine/sac_cot.py`), most recent last. The harness reads
the per-layer metrics straight after the traced stretch, so the stretch's
calls are the store's last `timeline.calls` records. The work comes from
the frozen models of `roofline.py` at each pair's valid count; only the
counts come from the program. A masked kernel that computes its padded rows
too does more work than these models count, and reads lower for it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from regbench import roofline


def traced_counts(timeline) -> Optional[np.ndarray]:
    """Each pair's valid count over the traced calls, call after call. None
    without a timeline, where the program keeps no store, or where the store
    holds fewer records than the stretch has calls, or a shard's counts."""
    if timeline is None or timeline.calls <= 0:
        return None
    try:
        from saccot_tpu_torch.engine.sac_cot import VALID_COUNTS
    except ImportError:
        return None
    records = list(VALID_COUNTS)[-timeline.calls:]
    if len(records) < timeline.calls or any(r.local for r in records):
        return None
    return np.concatenate([r.n_valid.reshape(-1).cpu().numpy() for r in records])


def share(timeline, models: Dict[str, Optional[Callable[[int], roofline.Model]]]
          ) -> Optional[float]:
    """The bound of the traced pairs' valid work over the device seconds of
    the kernels that ran it, in percent. `models`: {kernel name: the model of
    one pair at its valid count, or None for a kernel whose work another
    kernel's model counts}; a kernel that did not run adds neither work nor
    seconds. None without counts or without a launch of a modelled kernel."""
    counts = traced_counts(timeline)
    if counts is None:
        return None
    seconds, bound = 0.0, 0.0
    for kernel, model in models.items():
        s, launches = timeline.seconds_of([kernel])
        if launches == 0:
            continue
        seconds += s
        if model is not None:
            work = {"flops": 0.0, "bytes": 0.0}
            for n_b in counts.tolist():
                m = model(int(n_b))
                work["flops"] += m["flops"]
                work["bytes"] += m["bytes"]
            bound += roofline.bound_seconds(work)
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
