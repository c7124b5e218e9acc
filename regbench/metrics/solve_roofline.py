"""solve_roofline (layer: solve): the frozen solve model's bound over the
device seconds of the 3-point solve kernel, in percent."""

from regbench import roofline


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    work = roofline.solve_model(ctx.n, ctx.params["max_hypotheses"], ctx.batch)
    return roofline.stage_share(tl, {"solve3_kernel": work})
