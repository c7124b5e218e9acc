"""dispatch_ms (layer: host dispatch): the host milliseconds from a call of
`register_batch` to its return, the enqueue of a whole call, averaged over
the calls of the measured window (the profiler off)."""


def read(ctx):
    calls = ctx.window.calls
    if not calls:
        return None
    return 1e3 * sum(c.returned - c.enqueued for c in calls) / len(calls)
