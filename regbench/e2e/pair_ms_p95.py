"""pair_ms_p95: the 95th percentile, over every pair of the window, of the
milliseconds from its call's enqueue to its results on the host (every pair
of a call waits as long as its call)."""

import numpy as np


def read(ctx):
    calls = ctx.window.calls
    if not calls:
        return None
    per_call = np.array([(c.done - c.enqueued) * 1e3 for c in calls])
    return float(np.percentile(np.repeat(per_call, ctx.window.pairs_per_call), 95))
