"""valid_score_roofline (layer: score): the frozen scoring model at each
traced pair's valid count (the program's `VALID_COUNTS`) and the
configuration's K, summed, over the device seconds of the hypothesis-scoring
kernel, in percent."""

from regbench import roofline, valid


def read(ctx):
    K = ctx.params["max_hypotheses"]
    return valid.share(ctx.timeline, {"score_kernel": lambda n: roofline.scoring_model(n, K)})
