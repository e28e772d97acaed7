"""Trace forward: the least time the card could take for a step's K4
forwards (counts.bounce_bound_ms, from the cell's shapes) as a share of
K4's device time (bounce_fwd_kernel)."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.devtrace.device_ms(ctx.trace, include=("bounce_fwd_kernel",))
    if not ms:
        return None
    return 100.0 * ctx.counts.bounce_bound_ms(ctx.rays, ctx.bounces) / ms
