"""launches_per_call (layer: glue and refine): the kernels the card ran in
the traced stretch over its calls. A count: it repeats exactly while every
launch is recorded."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.launches() == 0:
        return None
    return tl.launches() / tl.calls
