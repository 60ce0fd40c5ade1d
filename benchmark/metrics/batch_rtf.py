"""batch_rtf: audio seconds of every 30 s window answered in the batches
that completed inside the measured window, over the window's length (from
one batch completion to the last within the window's seconds). Host clock;
whole batches, so a stall inside the window counts."""


def read(ctx):
    if ctx.generator != "window_backlog":
        return None
    return 30.0 * len(ctx.served.windows) / ctx.served.seconds
