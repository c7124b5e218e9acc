"""pairs_per_s: the pairs whose results reached the host inside the
window, over the window's seconds (from its first enqueue to the moment the
last results were on the host)."""


def read(ctx):
    w = ctx.window
    return w.pairs / w.seconds if w.calls and w.seconds > 0 else None
