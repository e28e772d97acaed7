"""The 95th percentile of the window's step times, each step timed by CUDA
events on the device from its first command to its last: the tail of a fit
loop's step, stalls of the host inside a step included."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.step_ms, dtype=np.float64), 95))
