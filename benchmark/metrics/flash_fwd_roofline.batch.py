"""flash_fwd_roofline.batch: kernel #1, the encoder's attention forward
(`ops/csrc/flash_attn_fwd.cu`), as a share of its roofline, in %: the
least time at the launch's shape (max_batch, heads, audio_ctx, head size)
and the card's published peaks (`flops.attention_bound_s`), over the mean
device time of its launches in the trace. Moves batch_rtf."""

KERNEL = "flash_attn_fwd"


def read(ctx):
    if ctx.generator != "window_backlog" or ctx.trace is None or ctx.peaks is None:
        return None
    times = ctx.trace.launches_of(KERNEL)
    if not times:
        return None
    s = ctx.shape
    shape = (ctx.served.max_batch, s.heads, s.audio_ctx, s.d // s.heads)
    bound, _ = ctx.flops.attention_bound_s(shape, ctx.peaks)
    return 100.0 * bound / (sum(times) / len(times))
