"""Host dispatch: device kernels in the traced window a step (copies and
fills by memset not counted).  The profiler now and then drops a launch,
so this may undercount by a little."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps
