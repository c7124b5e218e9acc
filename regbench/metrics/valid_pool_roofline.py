"""valid_pool_roofline (layer: triangle pool): the frozen pool models at
each traced pair's valid count n_b (the program's `VALID_COUNTS`), with
a = min(A, n_b) anchors and b = min(B, n_b - 1) neighbours, summed, over the
device seconds of the anchor kernels, in percent: `pool_model` for the fused
anchor kernel, `anchor_rows_model` for the streamed anchor rows."""

from regbench import roofline, valid


def read(ctx):
    A, B = ctx.params["num_anchors"], ctx.params["neighbors_per_anchor"]

    def fused(n):
        return roofline.pool_model(n, min(A, n), min(B, n - 1))

    def streamed(n):
        return roofline.anchor_rows_model(n, min(A, n), min(B, n - 1))

    return valid.share(ctx.timeline, {"anchor_topb_kernel": fused,
                                      "anchor_topb_stream_kernel": streamed})
