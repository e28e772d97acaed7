"""The step on the card: milliseconds a step in which some kernel, copy or
memset ran on the device (their union, on the device's clock), over every
step of the measured window, which runs with the profiler recording the
device's activity alone.  What a step takes once the host keeps the card
fed, and the card's time it holds from other work on the card."""

DEVICE_WINDOW = True


def read(ctx):
    tr = ctx.device
    if tr is None or not tr.kernels:
        return None
    return ctx.devtrace.busy_ns(tr) / 1e6 / tr.steps
