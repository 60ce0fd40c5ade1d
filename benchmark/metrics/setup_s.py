"""setup_s: seconds from the start of the run's process to the opening of
the measured window: loading, drawing the weights, building the engine,
loading (or, on a checkout's first run, building) the kernels, and the
warm-up that the cell's traffic generator makes. Host clock."""


def read(ctx):
    return ctx.setup_s
