"""Host dispatch: CUDA runtime calls that block the host (stream, device
and event synchronisations, synchronous copies) in the traced window a
step, less the step's own closing synchronise."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return ctx.trace.syncs / ctx.trace.steps - 1
