"""device.idle_untraced.batch: the card's idle share of an untraced batch,
in %: one minus the device's busy seconds in the traced batch over the
median host seconds of the window's other batches (`untraced_batch_s`).
Where the profiler delays the host's launches and not the kernels, this
is the idle that the program leaves, without the profiler's own (the
kernels' time is the trace's; that it does not grow under the profiler is
assumed, not measured). Moves batch_rtf."""

from benchmark.generators.window_backlog import untraced_batch_s


def read(ctx):
    if ctx.generator != "window_backlog" or ctx.trace is None:
        return None
    plain = untraced_batch_s(ctx.served)
    if plain is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / plain)
