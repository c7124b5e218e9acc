"""glue_ms (layer: glue and refine): device milliseconds a call of every
kernel outside the four stages' own kernels, which this file names and
holds fixed: the best-hypothesis choice, the refine, the pool's sorts and
dedup and every other torch operation of the estimator."""

from regbench.trace import kernel_pattern

# The hand-written kernels of the degree, pool, solve and score stages.
STAGED = ("two_sided_degrees_kernel", "tri_degrees_kernel", "degree_sum_kernel",
          "anchor_topb_kernel", "anchor_topb_stream_kernel",
          "solve3_kernel", "score_kernel")


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    staged = [kernel_pattern(k) for k in STAGED]
    glue = [n for n in tl.kernel_names() if not any(p.search(n) for p in staged)]
    if not glue:
        return None
    return 1e3 * sum(tl.op_seconds[n] for n in glue) / tl.calls
