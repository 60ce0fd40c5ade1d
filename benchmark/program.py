"""The system under test: the PyTorch and CUDA package
`speaksense_tpu_torch`, built from a configuration file and the weights
the benchmark drew. Only this file and the traffic generators import the program;
they take from it the served entry points and its counters.
"""

from __future__ import annotations

import torch

from benchmark.reference.whisper import Shape
from benchmark.weights import into_program


def dims(s: Shape):
    from speaksense_tpu_torch.models import whisper as W

    return W.WhisperDims(n_mels=s.n_mels, n_vocab=s.n_vocab, n_audio_ctx=s.audio_ctx,
                         n_audio_state=s.d, n_audio_head=s.heads, n_audio_layer=s.enc_layers,
                         n_text_ctx=s.text_ctx, n_text_state=s.d, n_text_head=s.heads,
                         n_text_layer=s.dec_layers)


def build_engine(cfg: dict, s: Shape, weights: dict, device, seed: int, **overrides):
    """A `WhisperEngine` on the drawn weights (bf16 model, the port's
    synthetic tokenizer), with the configuration's engine settings and
    `overrides` on top of them."""
    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.config import EngineConfig
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.models.tokenizer import Tokenizer

    model = W.Whisper(dims(s), device=device, dtype=torch.bfloat16)
    into_program(model, weights, s)
    settings = {**cfg["engine"], **overrides}
    return WhisperEngine(model, Tokenizer.synthetic(s.n_vocab), config=EngineConfig(**settings),
                         name=cfg["name"], seed=seed)


def counters() -> dict:
    """The program's metrics registry: counters and histogram sums."""
    from speaksense_tpu_torch.utils.metrics import REGISTRY

    snap = REGISTRY.snapshot()
    return {**snap["counters"],
            **{name + ".sum": h["sum"] for name, h in snap["histograms"].items()}}
