"""batcher.fill.batch: windows the window batcher ran over the rows of the
batches it ran (batches x max_batch), in %, over the traced stretch; from
the batcher's counters `windows_run` and `batches_run`. Moves batch_rtf:
a batch that runs with padding rows does the work of a full one."""

from benchmark.generators.window_backlog import traced_stretch


def read(ctx):
    if ctx.generator != "window_backlog":
        return None
    got = traced_stretch(ctx.served)
    if got is None:
        return None
    a, b, _, _ = got
    batches = b["batches_run"] - a["batches_run"]
    if batches <= 0:
        return None
    return 100.0 * (b["windows_run"] - a["windows_run"]) / (batches * ctx.served.max_batch)
