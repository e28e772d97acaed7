"""Backward: device ms a step of the kernels the backward launches: K4
bounce_bwd_kernel, K3's hard_bwd_kernel, the ordered scatter
(scatter_ordered_*) and the fills and glue of autograd."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.devtrace.device_ms(ctx.trace, span="raybench.backward")
    return ms or None
