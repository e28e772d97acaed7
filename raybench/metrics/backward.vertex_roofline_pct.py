"""Backward: the least time the card could take for a step's A3 launches,
the hit record's backward (counts.finalize_bwd_bound_ms, from the cell's
shapes), as a share of their device time (finalize_bwd_kernel).  Only a
step differentiated w.r.t. the vertices launches A3."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.devtrace.device_ms(ctx.trace, include=("finalize_bwd_kernel",))
    if not ms:
        return None
    return 100.0 * ctx.counts.finalize_bwd_bound_ms(ctx.rays, ctx.bounces) / ms
