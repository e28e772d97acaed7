"""Ray queries traced forward and backward per second: rays a step times
bounces, over every step the window completed, divided by the window's
wall time on the host's clock (many steps, never a single one)."""


def read(ctx):
    return ctx.rays * ctx.bounces * ctx.steps / ctx.window_s / 1e6
