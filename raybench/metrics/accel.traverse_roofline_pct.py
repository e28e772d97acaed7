"""Accel traversal: the least time the card could take for a step's
traversals (counts.traverse_bound_ms, from the cell's shapes) as a share
of their device time."""

PATTERNS = ("grid_shoot", "tree_shoot", "ropes_shoot", "brute_shoot")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.devtrace.device_ms(ctx.trace, include=PATTERNS)
    if not ms:
        return None
    return 100.0 * ctx.counts.traverse_bound_ms(ctx.rays, ctx.bounces) / ms
