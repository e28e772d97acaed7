"""Device: the share of the traced window's wall time in which no kernel,
copy or memset ran on the card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    tr = ctx.trace
    span = tr.window[1] - tr.window[0]
    return 100.0 * (1.0 - ctx.devtrace.busy_ns(tr) / span) if span > 0 else None
