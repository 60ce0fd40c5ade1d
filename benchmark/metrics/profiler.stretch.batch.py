"""profiler.stretch.batch: how much the profiler slows the batch it
traces, in %: the traced stretch's host seconds over the median of the
window's other batches (`untraced_batch_s`), 100 where it costs nothing.
The traced per-layer metrics (`device.idle.batch`, `mfu.batch`) read the
stretched batch; this is the factor to discount them by. Moves batch_rtf."""

from benchmark.generators.window_backlog import traced_stretch, untraced_batch_s


def read(ctx):
    if ctx.generator != "window_backlog":
        return None
    got, plain = traced_stretch(ctx.served), untraced_batch_s(ctx.served)
    if got is None or plain is None:
        return None
    return 100.0 * got[2] / plain
