"""Composition root of the port: the counterpart of `speaksense_tpu/main.py`.

Startup order mirrors the JAX package's (and the reference's src/main.rs:24-103):
env/config -> logging -> dirs -> ASR engine -> SQLite stores -> Auth + admin
key -> TaskManager + processors -> scheduler/workers -> gRPC server (with
etcd registration) -> REST server. A missing etcd does not abort gRPC
startup unless config.etcd_required.

`build_engine(config)` loads `config.model_path` (`ASR_MODEL_PATH`, by
default `./models/ggml-large-v3.bin`) through `WhisperEngine.from_pretrained`
and wraps it in the window batcher, as the JAX package does; a missing
checkpoint raises. `build_context(config, engine)` wires the task queue,
the stores and auth on it; it needs neither aiohttp nor grpcio, which the
front doors of `serve` import (the GPU image has neither).

Two pieces of the JAX `main.py` have no counterpart: the XLA compilation
cache (the port compiles only its kernels, cached under a source hash in
`ops/_build/`), and multi-chip serving: `--tp`/`--dp` above 1 and a set
`SPEAKSENSE_COORDINATOR` raise NotImplementedError (ROADMAP Queue 1 item 6)
rather than serve on one card.

Run: python -m speaksense_tpu_torch.main [--model PATH | --fake-engine] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.config import Config
from speaksense_tpu_torch.runtime.batcher import BatchedEngine
from speaksense_tpu_torch.utils import logging as logsetup

log = logging.getLogger("speaksense")


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


def build_context(config: Config, engine):
    """The REST handlers' AppContext (auth and task manager over the SQLite
    stores at `config.sqlite_file`) and the started TaskScheduler, wired as
    JAX `main.py:39-71`: admin key, usage accounting, the three processors,
    orphan recovery before any worker starts, `config.task_workers`
    Transcribe workers."""
    from speaksense_tpu_torch.auth import Auth
    from speaksense_tpu_torch.schedule.manager import TaskManager
    from speaksense_tpu_torch.schedule.processors import (
        NoiseReductionProcessor, TranscribeProcessor, VoiceprintProcessor,
    )
    from speaksense_tpu_torch.schedule.scheduler import create_scheduler
    from speaksense_tpu_torch.schedule.types import TaskType
    from speaksense_tpu_torch.serving.rest import AppContext
    from speaksense_tpu_torch.storage.sqlite import SqliteKeyStorage, SqliteTaskStorage

    task_storage = SqliteTaskStorage(config.sqlite_file)
    key_storage = SqliteKeyStorage(config.sqlite_file)
    auth = Auth(key_storage, key_storage)
    auth.initialize_admin_key()

    manager = TaskManager(task_storage)
    # completed tasks advance the creating key's total_tokens /
    # total_audio_seconds (the reference reserves these columns and never
    # fills them, key_stats_entity.rs:14-15)
    manager.usage_hook = auth.record_usage
    manager.register_processor(TranscribeProcessor(engine, audio_dir=config.audio_path))
    manager.register_processor(NoiseReductionProcessor(audio_dir=config.audio_path))
    manager.register_processor(VoiceprintProcessor(audio_dir=config.audio_path))
    # requeue rows stuck in Processing from a crashed/restarted previous
    # process BEFORE workers start (they are otherwise stranded forever)
    manager.recover_orphaned_tasks()
    scheduler = create_scheduler(
        manager,
        [TaskType.TRANSCRIBE, TaskType.NOISE_REDUCTION,
         TaskType.VOICEPRINT_RECOGNITION],
        workers={TaskType.TRANSCRIBE: config.task_workers})
    return AppContext(auth=auth, task_manager=manager), scheduler


def check_single_card(config: Config) -> None:
    """Multi-chip serving is not ported: refuse it instead of serving on one
    card."""
    if config.tp > 1 or config.dp > 1 or os.environ.get("SPEAKSENSE_COORDINATOR"):
        raise NotImplementedError(
            f"multi-GPU serving (tp={config.tp}, dp={config.dp}, SPEAKSENSE_COORDINATOR="
            f"{os.environ.get('SPEAKSENSE_COORDINATOR')!r}) is not ported yet "
            "(ROADMAP Queue 1 item 6); the port serves on one card")


async def serve(config: Config, fake_engine: bool = False,
                slot_serving: bool = False, slot_prompt: int = 16,
                condition: bool = True, slot_tokens: int = 96,
                slots: int | None = None, device="cuda") -> None:
    """Serve gRPC and REST until SIGTERM/SIGINT or the gRPC server ends,
    then drain: stop claiming tasks, finish the batcher's in-flight batch,
    stop the slot pool, deregister from etcd, close both servers."""
    check_single_card(config)
    from speaksense_tpu_torch.registry.etcd import EtcdRegistry
    from speaksense_tpu_torch.serving.grpc_server import GrpcServer
    from speaksense_tpu_torch.serving.rest import start_server

    config.init_dirs()
    if fake_engine:
        from speaksense_tpu_torch.asr.fake import FakeAsrEngine

        log.warning("using FakeAsrEngine (no model loaded)")
        engine = FakeAsrEngine()
    else:
        # all gRPC streams + task workers share one continuously-batched engine
        engine = build_engine(config, device=device, slot_serving=slot_serving,
                              slots=slots, slot_tokens=slot_tokens, slot_prompt=slot_prompt)
    inner = getattr(engine, "engine", engine)
    ctx, scheduler = build_context(config, engine)

    registry = EtcdRegistry(config.etcd_endpoint)
    grpc_server = GrpcServer(
        engine, port=config.grpc_port, registry=registry,
        # optional stream auth (SPEAKSENSE_GRPC_AUTH=optional|required): the
        # same key store as REST; off by default for reference wire parity
        auth=ctx.auth if config.grpc_auth in ("optional", "required") else None,
        require_auth=config.grpc_auth == "required",
        condition=condition)
    try:
        await grpc_server.start()
    except Exception:
        if config.etcd_required:
            raise
        log.exception("gRPC startup issue")

    runner = await start_server(ctx, port=config.http_port)
    log.info("SpeakSense (PyTorch port) up: gRPC :%d, REST :%d", config.grpc_port,
             config.http_port)

    # graceful shutdown: SIGTERM/SIGINT deregisters from etcd, stops claiming
    # new tasks, and drains the batcher/slot pool before exiting (the
    # reference has no drain path; streams just die — SURVEY §5)
    stop_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_event.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
    wait_task = asyncio.create_task(grpc_server.wait())
    stop_task = asyncio.create_task(stop_event.wait())
    try:
        await asyncio.wait({wait_task, stop_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if stop_event.is_set():
            log.info("shutdown signal received; draining")
    finally:
        scheduler.stop()
        if hasattr(engine, "stop"):
            engine.stop()          # window batcher: finish in-flight batch
        if hasattr(inner, "disable_slot_serving"):
            inner.disable_slot_serving()
        await grpc_server.stop()
        await runner.cleanup()
        for t in (wait_task, stop_task):
            t.cancel()


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The JAX server's flags, and --device."""
    parser = argparse.ArgumentParser(description="SpeakSense ASR server (PyTorch port)")
    parser.add_argument("--model", help="ggml model path (default: $ASR_MODEL_PATH)")
    parser.add_argument("--fake-engine", action="store_true",
                        help="serve with the deterministic fake engine (no model, no card)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (default cuda; cpu without a card)")
    parser.add_argument("--http-port", type=int)
    parser.add_argument("--grpc-port", type=int)
    parser.add_argument("--batch", type=int, default=None,
                        help="windows batched per engine step (default 8)")
    parser.add_argument("--int8-kv", action="store_true",
                        help="int8 cross-attention KV")
    parser.add_argument("--int8-self-kv", action="store_true",
                        help="int8 self-attention KV pages for full-window decodes, "
                             "quantized at ring flush")
    parser.add_argument("--int8-weights", action="store_true",
                        help="int8 decoder block weights (per-out-channel scales)")
    parser.add_argument("--beam-size", type=int, default=None,
                        help="beam search width at t=0 (default greedy)")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel width; above 1 is not ported yet (raises)")
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel width; above 1 is not ported yet (raises)")
    parser.add_argument("--slot-serving", action="store_true",
                        help="route streaming chunks through the token-level "
                             "slot pool (runtime/slots.py) instead of the "
                             "window batcher")
    parser.add_argument("--slot-prompt", type=int, default=16,
                        help="slot-pool prompt budget in tokens (default 16 "
                             "= plain SOT; 64 lets pooled streams carry "
                             "previous-text conditioning at the cost of a "
                             "larger per-slot KV page)")
    parser.add_argument("--no-condition", action="store_true",
                        help="disable previous-text conditioning on streams "
                             "(whisper.cpp no_context=true; the reference "
                             "serves no_context=false)")
    parser.add_argument("--slot-tokens", type=int, default=96,
                        help="slot-pool decode-token budget per 5 s chunk (default 96)")
    parser.add_argument("--slots", type=int, default=None,
                        help="slot-pool size (default EngineConfig.stream_slots)")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    """Config.from_env() with the flags applied over it."""
    config = Config.from_env()
    if args.model:
        config.model_path = args.model
    if args.http_port:
        config.http_port = args.http_port
    if args.grpc_port:
        config.grpc_port = args.grpc_port
    if args.batch:
        config.engine.max_batch_size = args.batch
    if args.int8_kv:
        config.engine.cross_kv_int8 = True
    if args.int8_self_kv:
        config.engine.self_kv_int8 = True
    if args.int8_weights:
        config.engine.weights_int8 = True
    if args.beam_size:
        config.engine.beam_size = args.beam_size
    if args.tp:
        config.tp = args.tp
    if args.dp:
        config.dp = args.dp
    return config


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    config = config_from_args(args)
    logsetup.init(config.log_dir)
    asyncio.run(serve(config, fake_engine=args.fake_engine,
                      slot_serving=args.slot_serving,
                      slot_prompt=args.slot_prompt,
                      condition=not args.no_condition,
                      slot_tokens=args.slot_tokens,
                      slots=args.slots, device=args.device))


if __name__ == "__main__":
    main()
