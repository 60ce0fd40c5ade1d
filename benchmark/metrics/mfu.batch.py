"""mfu.batch: the model operations of the windows that the traced batch
answered (encode, cross-KV, prompt and every token fed, logits; from the
configuration's shapes, `flops.window_flops`), over the traced window's
seconds times the card's published bf16 peak, in %. Moves batch_rtf."""

from benchmark.generators.window_backlog import emitted, traced_stretch


def read(ctx):
    if ctx.generator != "window_backlog" or ctx.trace is None or ctx.peaks is None:
        return None
    got = traced_stretch(ctx.served)
    if got is None or not got[3]:
        return None
    max_new = ctx.config["decoding"]["max_new_tokens"]
    prompt = ctx.config["decoding"]["prompt_tokens"]
    work = sum(ctx.flops.window_flops(ctx.shape, prompt, emitted(ctx.served.answers[k], max_new))
               for k in got[3])
    return 100.0 * work / (ctx.trace.window_s * ctx.peaks["bf16_flops"])
