"""Multi-host serving: the counterpart of `speaksense_tpu/parallel/multihost.py`.

Each host runs one server process per GPU (`parallel/workers.py`); the
default process group spans every rank of every host, so the hosts' groups
can be made, and each host serves its own requests and registers its own
etcd node: data parallel across hosts, tensor parallel only within a host
(`local_serving_mesh`), as in the JAX package. Requests never cross hosts.

Configuration is env-driven and a no-op when unset:
  SPEAKSENSE_COORDINATOR   host:port of the rendezvous (rank 0's host)
  SPEAKSENSE_NUM_PROCESSES host count
  SPEAKSENSE_PROCESS_ID    this host's index (0-based)
The JAX package runs one process per host, the port one per GPU: the world
size is hosts x local ranks and rank = host x local ranks + local rank,
where the local ranks are the server's own tp x dp (`main.worker_spec`).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from speaksense_tpu_torch.parallel.mesh import COMPUTE_TIMEOUT, Mesh, _mesh_of

log = logging.getLogger(__name__)


def backend_for(device) -> str:
    """gloo for CPU tensors and NCCL for CUDA ones on the card; gloo alone
    on the CPU."""
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" else "gloo"


def distributed_env() -> tuple[str, int, int] | None:
    """(coordinator, host count, host index) from the environment, or None
    when SPEAKSENSE_COORDINATOR or SPEAKSENSE_NUM_PROCESSES is unset. A
    coordinator without SPEAKSENSE_PROCESS_ID raises ValueError."""
    coordinator = os.environ.get("SPEAKSENSE_COORDINATOR")
    num_processes = int(os.environ.get("SPEAKSENSE_NUM_PROCESSES", "0") or 0)
    if not coordinator or not num_processes:
        return None
    pid = os.environ.get("SPEAKSENSE_PROCESS_ID")
    if pid is None:
        raise ValueError("SPEAKSENSE_PROCESS_ID must be set beside SPEAKSENSE_COORDINATOR")
    return coordinator, num_processes, int(pid)


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_ranks: int = 1,
                     local_rank: int = 0, backend: str | None = None,
                     timeout=COMPUTE_TIMEOUT) -> bool:
    """Start the default process group from the arguments or the
    environment (`distributed_env`), local_ranks processes a host. Returns
    True if a group of more than one rank was started; False (and nothing
    started) for a single process. backend defaults to
    `backend_for("cuda")` with a card, gloo without."""
    if coordinator is None and num_processes is None and process_id is None:
        coordinator, num_processes, process_id = distributed_env() or (None, 0, None)
    if not coordinator or not num_processes or num_processes * local_ranks <= 1:
        return False
    if process_id is None:
        raise ValueError("a process id must be given beside the coordinator")
    world = num_processes * local_ranks
    rank = process_id * local_ranks + local_rank
    backend = backend or backend_for("cuda" if torch.cuda.is_available() else "cpu")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=world,
                            rank=rank, timeout=timeout)
    log.info("process group up: rank %d of %d (host %d, coordinator %s, %s)", rank, world,
             process_id, coordinator, backend)
    return True


def local_serving_mesh(tp: int = 1, device: torch.device | None = None,
                       local_ranks: int = 1, timeout=COMPUTE_TIMEOUT) -> Mesh:
    """(dp, tp) mesh over THIS host's ranks: local_ranks of them,
    consecutive. Every rank of every host calls it: each host's groups are
    made by all ranks in the same order. Use `make_mesh` for one mesh over
    the whole world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % local_ranks or local_ranks % tp:
        raise ValueError(f"{world} ranks, {local_ranks} a host: tp={tp} must divide a host's "
                         f"ranks and a host's ranks the world")
    blocks = [np.arange(h * local_ranks, (h + 1) * local_ranks).reshape(local_ranks // tp, tp)
              for h in range(world // local_ranks)]
    return _mesh_of(blocks, device, timeout)
