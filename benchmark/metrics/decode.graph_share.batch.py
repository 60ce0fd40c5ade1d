"""decode.graph_share.batch: the share of the window decode loop's steps,
in %, that the program replayed from CUDA graphs over the traced stretch:
100 x the program's counter `asr_decode_graph_steps_total` over
`asr_decode_steps_total`, their growth between the stretch's two batch
completions. None where the program has no such counters. Moves batch_rtf:
a replayed step costs the host one launch instead of one per kernel."""

from benchmark.generators.window_backlog import traced_stretch

STEPS = "asr_decode_steps_total"
GRAPH_STEPS = "asr_decode_graph_steps_total"


def read(ctx):
    if ctx.generator != "window_backlog":
        return None
    got = traced_stretch(ctx.served)
    if got is None or STEPS not in got[1] or GRAPH_STEPS not in got[1]:
        return None
    a, b, _, _ = got
    steps = b[STEPS] - a.get(STEPS, 0.0)
    if steps <= 0:
        return None
    return 100.0 * (b[GRAPH_STEPS] - a.get(GRAPH_STEPS, 0.0)) / steps
