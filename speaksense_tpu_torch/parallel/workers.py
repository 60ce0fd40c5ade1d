"""The followers of a sharded engine: one process per GPU.

No JAX counterpart: the JAX package drives every chip of a host from one
process, whose one SPMD program XLA partitions. The port runs one process
per GPU instead. A single process driving every card would launch tp x dp
times the kernels from one thread, and the pool step is bound by its host
already (about 1,100 launches a step). The leader, local rank 0 of a host,
runs the front doors, the task queue and the pool's host logic; every
other local rank runs `run_followers`.

Each device call of the sharded engine (a window batch, a language
detection, a word alignment, a pool's admission, step, rebuild) is a method
marked `@collective(path)`. On the leader the mark broadcasts the call and
its inputs over the path's control group (`Mesh.call`), then runs it; each
follower receives it on the path's thread and runs the same method on its
own shard, so the collectives inside meet. The host decisions between
calls are made on the leader alone, from outputs every rank shares: the
logits are replicated over tp and the pool's per-slot results gathered over
dp. Sampling draws from generators seeded alike on the ranks that share
rows. The leader's `stop_followers` (a message of its own) ends the loops.
A call that raises on some ranks and not on all ends the workers, and the
leader's calls raise from then on (`parallel/mesh.py`, on faults).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import multiprocessing.connection
import os
import socket
import threading

import torch
import torch.distributed as dist

from speaksense_tpu_torch.parallel.mesh import PATHS

log = logging.getLogger(__name__)


def collective(path: str):
    """Mark a method of the engine or its pool as a device call of `path`
    ("window" or "pool"): on a leader the call goes to every follower too;
    unsharded, on a follower, or inside another such call it just runs."""
    def deco(fn):
        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            mesh = self.mesh
            if mesh is None or not mesh.leads or mesh.busy:
                return fn(self, *args, **kwargs)
            return mesh.call(path, self, fn, args, kwargs)
        return run
    return deco


def _follow(engine, path: str, errors: list, done: threading.Event) -> None:
    mesh = engine.mesh
    try:
        with mesh.on_path(path):
            while True:
                message = mesh.receive(path)
                if message is None:
                    return
                target, name, args, kwargs = message
                obj = engine if target == "engine" else engine._pool
                try:
                    getattr(obj, name)(*args, **kwargs)
                except Exception as e:
                    log.exception("follower rank %d: %s.%s failed", mesh.rank, target, name)
                    if not mesh.shared_fault(path):
                        raise RuntimeError(f"rank {mesh.rank} raised in {name}, the other "
                                           f"ranks not all with it") from e
    except Exception as e:   # a fault of this rank alone, or the group broke
        errors.append(e)
    finally:
        done.set()


def run_followers(engine) -> None:
    """Serve the leader's device calls on this rank's shard, one thread per
    path, until the leader stops them. Raises as soon as a path's call
    raised on this rank alone or its group broke (the leader is gone)."""
    errors: list = []
    done = threading.Event()
    threads = [threading.Thread(target=_follow, args=(engine, p, errors, done),
                                name=f"follower-{p}", daemon=True) for p in PATHS]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads) and not errors:
        done.wait()
        done.clear()
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------------
# local worker processes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerSpec:
    """What a local worker needs to join the leader's mesh: the process
    group (`multihost.init_distributed`'s arguments but the local rank),
    the tp width, each local rank's device, and a module-level function
    `build(*build_args, device=...)` -> WhisperEngine that every rank
    calls alike."""

    init: dict
    tp: int
    devices: list
    build: object
    build_args: tuple = ()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_devices(device, ranks: int) -> list:
    """Each local rank's device: card i for local rank i, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return ["cpu"] * ranks
    return [f"cuda:{i}" for i in range(ranks)]


def join_mesh(spec: WorkerSpec, local_rank: int):
    """Bring this process into its host's mesh: the process group, then
    the mesh on this rank's device. Every local rank calls it; the caller
    then builds its engine and shards it on the mesh (`engine.shard`)."""
    from speaksense_tpu_torch.parallel.multihost import init_distributed, local_serving_mesh

    device = torch.device(spec.devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(**spec.init, local_rank=local_rank)
    return local_serving_mesh(spec.tp, device=device, local_ranks=len(spec.devices))


def _worker_main(spec: WorkerSpec, local_rank: int) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(spec.devices)))
    mesh = join_mesh(spec, local_rank)
    try:
        engine = spec.build(*spec.build_args, device=mesh.device)
        engine.shard(mesh)
        run_followers(engine)
    except BaseException:
        # the mesh broke: leave at once, since a thread may wait in a
        # collective and tearing the group down would wait with it; the
        # leader sees this process end (`watch_workers`)
        log.exception("rank %d leaves the serving mesh", mesh.rank)
        logging.shutdown()
        os._exit(1)
    dist.destroy_process_group()


def start_workers(spec: WorkerSpec) -> list:
    """Start local ranks 1.. of spec's host as processes (spawned: the
    leader has threads). Local rank 0 is the caller, which then joins with
    `join_mesh(spec, 0)`."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker_main, args=(spec, r), name=f"speaksense-rank{r}",
                         daemon=False)
             for r in range(1, len(spec.devices))]
    for p in procs:
        p.start()
    return procs


def watch_workers(mesh, procs: list) -> None:
    """The leader's watch over its local workers, once it has joined the
    mesh: a worker that ends before `stop_workers` breaks the mesh
    (`Mesh.fail`), and a mesh that breaks kills the workers left, since one
    may wait in a collective for this rank."""
    def kill():
        for p in procs:
            if p.is_alive():
                p.kill()

    def watch():
        ready = multiprocessing.connection.wait([p.sentinel for p in procs])
        if not mesh.stopping:
            # a sentinel is ready when the worker's files close, a moment
            # before the process can be reaped: join it for its exit code
            ended = next(p for p in procs if p.sentinel in ready)
            ended.join(5)
            mesh.fail(f"worker {ended.name} ended with exit code {ended.exitcode}")

    mesh.on_break = kill
    if procs:
        threading.Thread(target=watch, name="watch-workers", daemon=True).start()


def stop_workers(mesh, procs: list, timeout: float = 60.0) -> None:
    """The leader's shutdown: stop the followers, leave the process group
    with them (NCCL's teardown waits for every rank's), then wait for their
    processes, killing any that outlive `timeout`."""
    try:
        if mesh is not None:
            mesh.stop_followers()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                log.error("worker %s did not stop; killing it", p.name)
                p.kill()
                p.join(5)
        if procs:
            log.info("local workers stopped, exit codes %s", [p.exitcode for p in procs])
