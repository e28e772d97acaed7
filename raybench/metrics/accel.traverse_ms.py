"""Accel traversal: device ms a step of the traversal kernels (K1
grid_shoot, B2 tree_shoot, B3 ropes_shoot, B1 brute_shoot)."""

PATTERNS = ("grid_shoot", "tree_shoot", "ropes_shoot", "brute_shoot")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.devtrace.device_ms(ctx.trace, include=PATTERNS)
    return ms or None
