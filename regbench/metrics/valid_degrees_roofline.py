"""valid_degrees_roofline (layer: compat degrees): the frozen degree model
at each traced pair's valid count (the program's `VALID_COUNTS`), summed,
over the device seconds of the degree kernels, in percent: the work a
masked deployment needs, against kernels that compute the padded rows too."""

from regbench import roofline, valid


def read(ctx):
    return valid.share(ctx.timeline, {"two_sided_degrees_kernel": roofline.compat_degrees_model,
                                      "tri_degrees_kernel": roofline.compat_degrees_model,
                                      "degree_sum_kernel": None})
