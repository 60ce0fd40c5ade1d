"""Composition root of the port: the counterpart of
`speaksense_tpu/main.py::build_engine` on random weights.

Serving REST and gRPC from the port waits until the shared serving stack
imports without jax; until then callers drive the returned engine through
the AsrEngine interface (`transcribe`, `transcribe_with_state`) and the
shared `speaksense_tpu.serving.stream.StreamSession`, as the servers and the
REST task workers do.
"""

from __future__ import annotations

from speaksense_tpu.config import Config
from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.runtime.batcher import BatchedEngine


def build_engine(config: Config, model: str = "large-v3", device="cuda", seed: int = 0,
                 max_wait_ms: float = 5.0, slot_serving: bool = False,
                 slots: int | None = None, slot_tokens: int = 96,
                 slot_prompt: int = 16) -> BatchedEngine:
    """A window-batching engine over a random-weight WhisperEngine of the
    named model, with weights drawn on `device` from `seed`. slot_serving
    routes stream chunks through the token-level slot pool of `slots` slots
    (default `config.engine.stream_slots`), `slot_tokens` new tokens and
    `slot_prompt` prompt tokens per chunk."""
    engine = WhisperEngine.from_random(model, config=config.engine, device=device, seed=seed)
    if slot_serving:
        engine.enable_slot_serving(n_slots=slots, max_new=slot_tokens, max_prompt=slot_prompt)
    return BatchedEngine(engine, max_wait_ms=max_wait_ms)
