"""Faults planted in the program underneath a whole run, for the tests and
for `control.py`'s readings on the card: each must turn `correct` false.

- "token altered where produced": every window's third token is swapped
  for another as the decode loop returns it;
- "step returns its state unchanged": every decode step returns the
  logits of its batch's first step, so the decoder never advances;
- "half of the batch left out": the second half of a batch's rows get the
  first half's answers, and their own are never computed into them.

(A cell on one card has no exchange between chips to leave out.)
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("token altered where produced", "step returns its state unchanged",
          "half of the batch left out")


@contextlib.contextmanager
def planted(name: str):
    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.models import decode as D
    from speaksense_tpu_torch.models import whisper as W

    if name == FAULTS[0]:
        owner, attr, orig = D, "decode_loop", D.decode_loop

        def broken(*a, **k):
            out = orig(*a, **k)
            out["tokens"][:, 2] = torch.where(out["tokens"][:, 2] == 17, 18, 17)
            return out
    elif name == FAULTS[1]:
        owner, attr, orig = W, "decode_step", W.decode_step
        first: dict = {}

        def broken(model, token, cache, *a, **k):
            if id(cache) not in first:
                first[id(cache)] = orig(model, token, cache, *a, **k)
            return first[id(cache)]
    elif name == FAULTS[2]:
        owner, attr, orig = WhisperEngine, "decode_windows", WhisperEngine.decode_windows

        def broken(self, mels, *a, **k):
            res = orig(self, mels, *a, **k)
            h = len(res) // 2
            return res[:h] + res[:h] + res[2 * h:]
    else:
        raise KeyError(name)
    setattr(owner, attr, broken)
    try:
        yield
    finally:
        setattr(owner, attr, orig)
