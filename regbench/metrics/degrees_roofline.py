"""degrees_roofline (layer: compat degrees): the frozen degree model's
bound over the device seconds of the degree kernels, in percent: the
two-sided kernel (N <= 2,048) or the symmetric one with its tile sum."""

from regbench import roofline


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    work = roofline.compat_degrees_model(ctx.n, ctx.batch)
    return roofline.stage_share(tl, {"two_sided_degrees_kernel": work,
                                     "tri_degrees_kernel": work, "degree_sum_kernel": None})
