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

Multi-GPU serving follows JAX `main.py:86-112`: tp = `--tp` (default 1), dp
= `--dp` (default: the local cards // tp), tp x dp above the local cards
raises ValueError, and tp = dp = 1 builds no process group and no mesh. The
port runs one process per GPU: this process is local rank 0, the leader,
which serves; it starts the other tp x dp - 1 local ranks itself
(`parallel/workers.py`), which follow. With `SPEAKSENSE_COORDINATOR` (and
`_NUM_PROCESSES`, `_PROCESS_ID`) the hosts join one process group and each
host serves its own requests on its own mesh (`parallel/multihost.py`).
The XLA compilation cache has no counterpart: the port compiles only its
kernels, cached under a source hash in `ops/_build/`.

Run: python -m speaksense_tpu_torch.main [--model PATH | --fake-engine] [--device cpu]
     [--tp N] [--dp N]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

import torch

from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.config import Config
from speaksense_tpu_torch.runtime.batcher import BatchedEngine
from speaksense_tpu_torch.utils import logging as logsetup

log = logging.getLogger("speaksense")


def load_engine(config: Config, model: str | None = None, seed: int = 0,
                device="cuda", decoder_layers: int | None = None) -> WhisperEngine:
    """The WhisperEngine on `device` over the checkpoint at
    `config.model_path` (ggml file or HF directory), or, when `model` names
    one of `MODEL_DIMS`, over random weights of that model drawn from
    `seed` (its decoder cut to `decoder_layers` when given). Every rank of
    a mesh builds its engine with it."""
    if model is None:
        return WhisperEngine.from_pretrained(config.model_path, config=config.engine,
                                             device=device)
    return WhisperEngine.from_random(model, config=config.engine, device=device, seed=seed,
                                     decoder_layers=decoder_layers)


def build_engine(config: Config, model: str | None = None, device="cuda", seed: int = 0,
                 max_wait_ms: float = 5.0, slot_serving: bool = False,
                 slots: int | None = None, slot_tokens: int = 96,
                 slot_prompt: int = 16, mesh=None,
                 decoder_layers: int | None = None) -> BatchedEngine:
    """A window-batching engine over `load_engine(config, model, seed,
    device, decoder_layers)`, sharded on `mesh` (this process leads it)
    when given. slot_serving routes stream chunks through the token-level
    slot pool of `slots` slots (default `config.engine.stream_slots`),
    `slot_tokens` new tokens and `slot_prompt` prompt tokens per chunk."""
    engine = load_engine(config, model, seed, device, decoder_layers)
    if mesh is not None:
        engine.shard(mesh)
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


def serving_layout(config: Config, device="cuda") -> tuple[int, int]:
    """(tp, dp) of this host's mesh, JAX `main.py:98-107`: tp = config.tp,
    dp = config.dp or the local cards // tp; tp x dp above the local cards
    raises ValueError. On the CPU the ranks are processes, as many as asked."""
    tp = max(1, config.tp)
    if torch.device(device).type == "cuda":
        n_local = torch.cuda.device_count()
    else:
        n_local = tp * max(1, config.dp)
    dp = config.dp or max(1, n_local // tp)
    if tp * dp > n_local:
        raise ValueError(f"tp={tp} x dp={dp} exceeds {n_local} local devices")
    return tp, dp


def worker_spec(config: Config, tp: int, dp: int, device="cuda", model: str | None = None,
                seed: int = 0):
    """The `parallel.workers.WorkerSpec` of this host's tp x dp ranks, or
    None when the server is one process: one host (no
    SPEAKSENSE_COORDINATOR) and tp = dp = 1."""
    from speaksense_tpu_torch.parallel.multihost import distributed_env
    from speaksense_tpu_torch.parallel.workers import WorkerSpec, free_port, local_devices

    local = tp * dp
    hosts = distributed_env()
    if hosts is None and local == 1:
        return None
    if hosts is None:
        init = dict(coordinator=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0)
    else:
        coordinator, num_processes, process_id = hosts
        init = dict(coordinator=coordinator, num_processes=num_processes,
                    process_id=process_id)
    return WorkerSpec(init={**init, "local_ranks": local}, tp=tp,
                      devices=local_devices(device, local), build=load_engine,
                      build_args=(config, model, seed))


async def serve(config: Config, fake_engine: bool = False,
                slot_serving: bool = False, slot_prompt: int = 16,
                condition: bool = True, slot_tokens: int = 96,
                slots: int | None = None, device="cuda") -> None:
    """Serve gRPC and REST until SIGTERM/SIGINT or the gRPC server ends,
    then drain: stop claiming tasks, finish the batcher's in-flight batch,
    stop the slot pool, deregister from etcd, close both servers. On a
    mesh this process leads: it starts the other local ranks first and
    stops them last."""
    from speaksense_tpu_torch.parallel.workers import (join_mesh, start_workers, stop_workers,
                                                       watch_workers)

    spec = None
    if not fake_engine:
        spec = worker_spec(config, *serving_layout(config, device), device=device)
    config.init_dirs()
    procs, mesh = [], None
    if spec is not None:
        procs = start_workers(spec)
        device = spec.devices[0]
    try:
        if spec is not None:
            mesh = join_mesh(spec, 0)
            watch_workers(mesh, procs)
        await _serve(config, fake_engine, slot_serving, slot_prompt, condition, slot_tokens,
                     slots, device, mesh)
    finally:
        if spec is not None:
            stop_workers(mesh, procs)


async def _serve(config: Config, fake_engine: bool, slot_serving: bool, slot_prompt: int,
                 condition: bool, slot_tokens: int, slots: int | None, device, mesh) -> None:
    from speaksense_tpu_torch.registry.etcd import EtcdRegistry
    from speaksense_tpu_torch.serving.grpc_server import GrpcServer
    from speaksense_tpu_torch.serving.rest import start_server

    if fake_engine:
        from speaksense_tpu_torch.asr.fake import FakeAsrEngine

        log.warning("using FakeAsrEngine (no model loaded)")
        engine = FakeAsrEngine()
    else:
        # all gRPC streams + task workers share one continuously-batched engine
        engine = build_engine(config, device=device, slot_serving=slot_serving,
                              slots=slots, slot_tokens=slot_tokens, slot_prompt=slot_prompt,
                              mesh=mesh)
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
                        help="tensor-parallel width: GPUs (one process each) that "
                             "split the model (default 1)")
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel width: replicas that split the slot "
                             "pool's rows (default: local GPUs // tp)")
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
