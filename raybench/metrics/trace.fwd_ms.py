"""Trace forward: device ms a step of the kernels the forward launches
other than the traversal's: K2 finalize_hits, K4 bounce_fwd_kernel, K3
energy_histogram and the torch glue between them."""

TRAVERSAL = ("grid_shoot", "tree_shoot", "ropes_shoot", "brute_shoot")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.devtrace.device_ms(ctx.trace, span="raybench.forward", exclude=TRAVERSAL)
    return ms or None
