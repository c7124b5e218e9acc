"""score_roofline (layer: score): the frozen scoring model's bound over the
device seconds of the hypothesis-scoring kernel, in percent."""

from regbench import roofline


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    work = roofline.scoring_model(ctx.n, ctx.params["max_hypotheses"], ctx.batch)
    return roofline.stage_share(tl, {"score_kernel": work})
