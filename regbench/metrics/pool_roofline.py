"""pool_roofline (layer: triangle pool): the frozen pool models' bounds
over the device seconds of the anchor kernels, in percent: the fused anchor
kernel (N <= 4,096: anchor rows, neighbours and every candidate's score) or
the streamed anchor rows. The exact pool's selection and dedup are torch
operations, read by glue_ms."""

from regbench import roofline


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    n, prm, batch = ctx.n, ctx.params, ctx.batch
    a = min(prm["num_anchors"], n)
    b = min(prm["neighbors_per_anchor"], n - 1)
    return roofline.stage_share(tl, {
        "anchor_topb_kernel": roofline.pool_model(n, a, b, batch),
        "anchor_topb_stream_kernel": roofline.anchor_rows_model(n, a, b, batch),
    })
