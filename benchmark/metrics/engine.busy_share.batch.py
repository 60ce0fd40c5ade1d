"""engine.busy_share.batch: the share of the traced stretch, in %, that the
engine spent inside `decode_windows` (the sum of the program's histogram
`asr_decode_window_seconds` over the stretch, over its host seconds). The
rest is the batcher's and the client thread's time between batches. Moves
batch_rtf."""

from benchmark.generators.window_backlog import traced_stretch

NAME = "asr_decode_window_seconds.sum"


def read(ctx):
    if ctx.generator != "window_backlog":
        return None
    got = traced_stretch(ctx.served)
    if got is None or NAME not in got[1]:
        return None
    a, b, seconds, _ = got
    return 100.0 * (b[NAME] - a.get(NAME, 0.0)) / seconds
