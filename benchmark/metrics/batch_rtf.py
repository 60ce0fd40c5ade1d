"""batch_rtf: audio seconds answered inside the measured window, over the
window's length. Host clock.

A generator states both on the record it serves: `audio_s`, the audio
seconds of every request answered inside the window, and `seconds`, the
window's length. For `window_backlog` that is 30 s for every window
answered in the batches that completed inside the window, over the time
from one batch completion to the last within the window's seconds; whole
batches, so a stall inside the window counts. None where the record
states no `audio_s`."""


def read(ctx):
    audio_s = getattr(ctx.served, "audio_s", None)
    if audio_s is None:
        return None
    return audio_s / ctx.served.seconds
