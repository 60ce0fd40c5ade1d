"""device.idle.batch: the share of the traced window, in %, in which no
kernel or copy ran on the card (`torch.profiler`'s device events, their
union against the window). Moves batch_rtf."""


def read(ctx):
    if ctx.generator != "window_backlog" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
