"""Composition root of the port: the counterpart of
`speaksense_tpu/main.py::build_engine`.

`build_engine(config)` loads `config.model_path` (`ASR_MODEL_PATH`, by
default `./models/ggml-large-v3.bin`) through `WhisperEngine.from_pretrained`
and wraps it in the window batcher, as the JAX package does; a missing
checkpoint raises. Serving REST and gRPC from the port is still to come;
until then callers drive the returned engine through the AsrEngine interface
(`transcribe`, `transcribe_with_state`) and the port's
`speaksense_tpu_torch.serving.stream.StreamSession`, as the servers and the
REST task workers do.
"""

from __future__ import annotations

from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.config import Config
from speaksense_tpu_torch.runtime.batcher import BatchedEngine


def build_engine(config: Config, model: str | None = None, device="cuda", seed: int = 0,
                 max_wait_ms: float = 5.0, slot_serving: bool = False,
                 slots: int | None = None, slot_tokens: int = 96,
                 slot_prompt: int = 16) -> BatchedEngine:
    """A window-batching engine on `device` over the checkpoint at
    `config.model_path` (ggml file or HF directory), or, when `model` names
    one of `MODEL_DIMS`, over random weights of that model drawn from
    `seed`. slot_serving routes stream chunks through the token-level slot
    pool of `slots` slots (default `config.engine.stream_slots`),
    `slot_tokens` new tokens and `slot_prompt` prompt tokens per chunk."""
    if model is None:
        engine = WhisperEngine.from_pretrained(config.model_path, config=config.engine,
                                               device=device)
    else:
        engine = WhisperEngine.from_random(model, config=config.engine, device=device,
                                           seed=seed)
    if slot_serving:
        engine.enable_slot_serving(n_slots=slots, max_new=slot_tokens, max_prompt=slot_prompt)
    return BatchedEngine(engine, max_wait_ms=max_wait_ms)
