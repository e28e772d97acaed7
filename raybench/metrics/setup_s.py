"""Process start to the first timed step: the faces, Topology.build, the
structure, the upload, the ray pool and the warm-up (the first run in a
checkout builds the kernels too)."""


def read(ctx):
    return ctx.setup_s
