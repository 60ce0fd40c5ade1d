"""Serving mesh and the Whisper sharding rules: the counterpart of
`speaksense_tpu/parallel/mesh.py`.

Layout (Megatron-style tensor parallel over `tp`, data parallel over `dp`),
the JAX package's:
- attention q/k/v (the fused qkv), cq/ck/cv and mlp fc1: column-parallel,
  the out-features (weight rows, bias, int8 `wq` rows and `ws`) split over
  tp, so each rank holds n_head / tp heads of every attention. The fused
  qkv is split per head: each rank keeps its heads of q, of k and of v;
- attention o/co and mlp fc2: row-parallel, the in-features split over tp.
  The bias and the int8 per-output-channel scale `ws` stay whole; the f32
  partial products are summed over tp (`Mesh.all_reduce`) before the bias
  is added and the result rounded once;
- embeddings, norms, the conv stem, positional tables and the logits:
  replicated. Every tp rank computes the same logits, so every rank samples
  the same tokens from generators seeded alike;
- the slot pool's rows split over dp ((S + 1) / dp rows each, the
  reference's S slots and one scratch row), heads over tp.

One process per GPU (`parallel/workers.py`) replaces the JAX package's one
controller per host, and the collectives are explicit. Two threads of the
leader issue device work, the window batcher and the slot pool's server,
and a communicator must see its collectives in the same order on every
rank. So each path ("window", "pool") gets its own process groups over the
same ranks: a control group that carries the leader's calls to the
followers, and the tp and dp groups of its collectives; each follower runs
one thread per path, and on the card each path has its own CUDA stream.
Serialising both paths through one set of groups would be simpler but
would stall the pool's steps behind every window batch. The control groups
wait for the leader's next call without a time limit (a follower idles as
long as the server does); the compute groups time out after
COMPUTE_TIMEOUT, the last guard against a hang.

A fault is a call that raises on some rank. Where every rank raises in it,
as inputs that every rank was given can make them, each left it at the same
collective and the mesh goes on: the ranks learn it from a barrier over the
path's fault group, which waits FAULT_GRACE for them. Otherwise a rank may
wait in a collective that will never come, and the mesh breaks
(`Mesh.fail`): a follower leaves its process, the leader kills its local
workers (`workers.watch_workers`) and aborts its compute groups (a gloo
collective ends when its peer's process does, an NCCL one only when its
communicator is aborted), and the call in flight and every later one raise
on the leader at once. The server then fails its requests instead of
hanging them, until it is restarted.

`Mesh` mirrors the JAX mesh where callers read it (`devices`,
`axis_names`, `shape`); it is not torch's DeviceMesh, whose groups cover
one set of ranks per dimension and must be created by every rank of the
mesh alone, where a multi-host world needs each host's groups made by
every rank in the same order (`multihost.local_serving_mesh`).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

log = logging.getLogger(__name__)

PATHS = ("window", "pool")
# how long a collective waits for the other ranks before it raises
COMPUTE_TIMEOUT = datetime.timedelta(minutes=5)
# how long a rank whose call raised waits for the others to raise in it too:
# ranks in step reach a shared fault within milliseconds of each other
FAULT_GRACE = datetime.timedelta(seconds=5)
# followers wait for the leader's next call as long as the server idles
_CONTROL_TIMEOUT = datetime.timedelta(days=365)

# column-parallel projections (out-features on tp) and row-parallel ones
# (in-features on tp; the partial products are summed over tp)
_COL_PROJ = {"q", "k", "v", "qkv", "cq", "ck", "cv", "fc1"}
_ROW_PROJ = {"o", "co", "fc2"}


@dataclass
class _PathGroups:
    control: object    # every rank of the mesh: the leader's calls
    fault: object      # every rank of the mesh, gloo: the barrier after a fault
    tp: object         # this rank's row of the mesh
    dp: object         # this rank's column of the mesh


class Mesh:
    """(dp, tp) layout of global ranks: `devices[d, t]` is the rank holding
    tp shard t of dp replica d. Built by `make_mesh` (one mesh over the
    given ranks) or `multihost.local_serving_mesh` (this host's ranks). A
    mesh made before a process group exists is a layout only: it has no
    groups, and it is the view of its first rank."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray, groups: dict | None = None,
                 device: torch.device | None = None):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "tp": devices.shape[1]}
        self.groups = groups
        self.rank = dist.get_rank() if dist.is_initialized() else int(devices.flat[0])
        where = np.argwhere(devices == self.rank)
        if not where.size:
            raise ValueError(f"rank {self.rank} is not in the mesh {devices.tolist()}")
        self.dp_index, self.tp_index = (int(i) for i in where[0])
        self.device = device
        self.leader = int(devices.flat[0])
        self._local = threading.local()
        self._locks = {p: threading.Lock() for p in PATHS}
        self._streams: dict = {}
        self.broken: str | None = None    # why the mesh broke (`fail`)
        self.stopping = False             # the leader's stop messages are out
        self.on_break = None              # the leader's callback when it breaks

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def leads(self) -> bool:
        """Whether this rank issues the mesh's calls to followers."""
        return self.rank == self.leader and self.size > 1 and self.groups is not None

    @property
    def busy(self) -> bool:
        """Whether this thread is inside a path's call (a nested device
        call then runs where it is)."""
        return getattr(self._local, "path", None) is not None

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, ranks={self.devices.tolist()})"

    # ----------------------------------------------------------- collectives

    def _group(self, axis: str):
        return getattr(self.groups[getattr(self._local, "path", None) or "window"], axis)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over this rank's tp group, in place (f32 partial products of a
        row-parallel layer)."""
        dist.all_reduce(t, group=self._group("tp"))
        return t

    def all_gather(self, t: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
        """Concatenation along `dim` of every rank's `t` over `axis`, in
        mesh order."""
        group = self._group(axis)
        n = dist.get_world_size(group)
        if n == 1:
            return t
        # a CUDA tensor on a group without NCCL (two ranks sharing one card
        # over gloo) is gathered through the host
        on_host = t.is_cuda and "nccl" not in str(dist.get_backend(group))
        src = t.cpu() if on_host else t
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src.contiguous(), group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    # ------------------------------------------------------- calls and paths

    @contextlib.contextmanager
    def on_path(self, path: str):
        """Run the body as device work of `path`: its groups for the
        collectives and, on the card, its own stream."""
        prev = getattr(self._local, "path", None)
        self._local.path = path
        try:
            if self.device is not None and self.device.type == "cuda":
                stream = self._streams.get(path)
                if stream is None:
                    stream = self._streams[path] = torch.cuda.Stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    yield
                torch.cuda.current_stream(self.device).wait_stream(stream)
            else:
                yield
        finally:
            self._local.path = prev

    def call(self, path: str, obj, fn, args: tuple, kwargs: dict):
        """On the leader: send the call of `fn` on `obj` (the engine, or its
        pool) to every follower of `path`, then run it here; the followers
        run it on their shards (`workers.run_followers`), so the collectives
        inside meet. Raises at once on a broken mesh."""
        with self._locks[path]:
            self._check()
            self.send(path, (obj.spmd_target, fn.__name__, _to_host(args), _to_host(kwargs)))
            with self.on_path(path):
                try:
                    out = fn(obj, *args, **kwargs)
                    # an NCCL collective that `fail` aborted ends without an
                    # error: a call the mesh broke under fails all the same
                    self._check()
                    return out
                except Exception as e:
                    if self.broken is None and not self.shared_fault(path):
                        self.fail(f"rank {self.rank} raised in {fn.__name__} "
                                  f"({type(e).__name__}: {e}), the followers not all with it")
                    self._check()
                    raise

    def _check(self) -> None:
        if self.broken is not None:
            raise RuntimeError(f"the serving mesh broke: {self.broken}; restart the server")

    def shared_fault(self, path: str) -> bool:
        """After a call of `path` raised on this rank: whether every rank
        of the mesh raised in it (the barrier of the path's fault group,
        FAULT_GRACE long)."""
        try:
            dist.barrier(group=self.groups[path].fault)
            return True
        except Exception:
            return False

    def fail(self, reason: str) -> None:
        """Break the mesh: its calls raise from now on. Aborts this rank's
        compute groups, so a collective waiting for a rank that is gone
        ends, and runs `on_break` (the leader kills its local workers)."""
        if self.broken is not None:
            return
        self.broken = reason
        log.error("the serving mesh broke: %s", reason)
        if self.on_break is not None:
            self.on_break()
        for groups in (self.groups or {}).values():
            for group in (groups.tp, groups.dp):
                group.abort()

    def send(self, path: str, message) -> None:
        dist.broadcast_object_list([message], src=self.leader,
                                   group=self.groups[path].control, device=torch.device("cpu"))

    def receive(self, path: str):
        """A follower's next message on `path` (None: stop), tensors moved to
        this rank's device."""
        box = [None]
        dist.broadcast_object_list(box, src=self.leader, group=self.groups[path].control,
                                   device=torch.device("cpu"))
        return _to_device(box[0], self.device or torch.device("cpu"))

    def stop_followers(self) -> None:
        """The leader's stop message on every path: the followers leave
        their loops. A broken mesh has none left to stop."""
        self.stopping = True
        if self.leads and self.broken is None:
            for path in PATHS:
                with self._locks[path]:
                    self.send(path, None)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return x


def _new_groups(blocks: list[np.ndarray], rank: int, timeout) -> dict | None:
    """Every path's groups of every block (one (dp, tp) rank array per
    host), created by every rank in the same order; returns this rank's."""
    if not dist.is_initialized():
        return None
    mine: dict = {}
    for path in PATHS:
        for arr in blocks:
            control = dist.new_group(arr.reshape(-1).tolist(), timeout=_CONTROL_TIMEOUT)
            fault = dist.new_group(arr.reshape(-1).tolist(), timeout=FAULT_GRACE,
                                   backend="gloo")
            tps = [dist.new_group(row.tolist(), timeout=timeout) for row in arr]
            dps = [dist.new_group(col.tolist(), timeout=timeout) for col in arr.T]
            where = np.argwhere(arr == rank)
            if where.size:
                d, t = where[0]
                mine[path] = _PathGroups(control, fault, tps[d], dps[t])
    return mine


def _mesh_of(blocks: list[np.ndarray], device, timeout) -> Mesh:
    rank = dist.get_rank() if dist.is_initialized() else int(blocks[0].flat[0])
    groups = _new_groups(blocks, rank, timeout)
    arr = next((a for a in blocks if rank in a), blocks[0])   # else Mesh() raises
    return Mesh(arr, groups, device)


def make_mesh(n_devices: int | None = None, tp: int = 1, devices: list | None = None,
              device: torch.device | None = None, timeout=COMPUTE_TIMEOUT) -> Mesh:
    """(dp, tp) mesh over the first n_devices of `devices` (global ranks;
    default every rank of the default group, or range(n_devices) before
    one exists). tp must divide n_devices. Every rank of the default group
    calls this with the same arguments; `device` is this rank's card (or
    the CPU) for the mesh's per-path streams."""
    if devices is None:
        devices = list(range(dist.get_world_size() if dist.is_initialized()
                             else n_devices or 1))
    n = n_devices or len(devices)
    if n % tp:
        raise ValueError(f"tp={tp} must divide n_devices={n}")
    arr = np.asarray(devices[:n]).reshape(n // tp, tp)
    return _mesh_of([arr], device, timeout)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shardings(model: nn.Module) -> dict:
    """{parameter name: spec} for the port's Whisper, any layout (the fused
    qkv, int8 blocks with their scales): a spec names the mesh axis of each
    dimension, as a JAX PartitionSpec does. Linear weights are (out, in):
    a column-parallel layer splits dim 0 of its weight, wq, ws and bias, a
    row-parallel one dim 1 of its weight and wq; all else is replicated.
    Derived from the module tree, as the JAX rule is from the pytree."""
    specs = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        spec = (None,) * p.dim()
        if "blocks" in parts and len(parts) >= 5:
            proj, leaf = parts[-2], parts[-1]
            if proj in _COL_PROJ and leaf in ("weight", "wq", "ws", "bias"):
                spec = ("tp",) + (None,) * (p.dim() - 1)
            elif proj in _ROW_PROJ and leaf in ("weight", "wq"):
                spec = (None, "tp")
        specs[name] = spec
    return specs


def _shard(x: torch.Tensor, dim: int, tp: int, i: int, thirds: bool) -> torch.Tensor:
    """Shard i of tp along dim; with thirds (the fused qkv), shard i of
    each third, so the rank keeps its heads of q, k and v."""
    if thirds:
        return torch.cat([_shard(part, dim, tp, i, False) for part in x.chunk(3, dim)], dim)
    n = x.shape[dim] // tp
    return x.narrow(dim, i * n, n).clone()


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's tp shard of every parameter (`param_shardings`), in
    place, and make the model's attention count local heads and its
    row-parallel layers sum over the mesh's tp group. Returns the model."""
    tp, i = mesh.shape["tp"], mesh.tp_index
    dims = model.dims
    for heads in (dims.n_audio_head, dims.n_text_head):
        if heads % tp:
            raise ValueError(f"tp={tp} must divide the head count {heads}")
    if tp == 1:
        return model
    for name, spec in param_shardings(model).items():
        if "tp" not in spec:
            continue
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        p = getattr(mod, leaf)
        part = _shard(p.data, spec.index("tp"), tp, i, mod_name.endswith(".qkv"))
        setattr(mod, leaf, nn.Parameter(part, requires_grad=False))
    for mod_name, mod in model.named_modules():
        if mod_name.rsplit(".", 1)[-1] in _ROW_PROJ and "blocks" in mod_name:
            mod.reduce = mesh.all_reduce
    model.n_audio_head = dims.n_audio_head // tp
    model.n_text_head = dims.n_text_head // tp
    model.mesh = mesh
    return model


# ---------------------------------------------------------------------------
# decode caches and the slot pool's state
# ---------------------------------------------------------------------------

_KV = ("self_k", "self_v", "cross_k", "cross_v", "cross_ks", "cross_vs", "ring_k", "ring_v",
       "self_ks", "self_vs")


def cache_shardings(self_kv_int8: bool = False) -> dict:
    """Specs of `models/whisper.KVCache`: pages (L, B, H, T, Dh), rows on
    dp and heads on tp; per-token int8 scales (L, B, H, T) the same."""
    kv = (None, "dp", "tp", None, None)
    out = {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv}
    if self_kv_int8:
        out["self_ks"] = out["self_vs"] = (None, "dp", "tp", None)
    return out


def _state_tensors(state) -> dict:
    """{name: tensor} of a PoolState or BeamPoolState, its pages' tensors
    by their KVCache names."""
    out = {}
    for k, v in vars(state).items():
        if k == "pages":
            out.update({n: t for n, t in vars(v).items() if t is not None})
        elif isinstance(v, torch.Tensor):
            out[k] = v
    return out


def pool_state_shardings(state) -> dict:
    """Specs of a slot pool's state (`models/decode.PoolState`,
    `models/beam.BeamPoolState`): the pages' rows on dp and heads on tp,
    every other tensor's slot axis (its first) on dp."""
    specs = {}
    for k, v in _state_tensors(state).items():
        if k in _KV:
            specs[k] = (None, "dp", "tp") + (None,) * (v.dim() - 3)
        else:
            specs[k] = ("dp",) + (None,) * (v.dim() - 1)
    return specs


def shard_pool_state(state, mesh: Mesh):
    """This rank's part of a whole pool state (rows on dp, heads on tp), as
    a new state of the same class. The pool builds its part directly on a
    sharded model; this is the rule that part follows."""
    specs = pool_state_shardings(state)
    index = {"dp": mesh.dp_index, "tp": mesh.tp_index}

    def part(name, t):
        for dim, axis in enumerate(specs[name]):
            if axis is not None and mesh.shape[axis] > 1:
                n = t.shape[dim] // mesh.shape[axis]
                t = t.narrow(dim, index[axis] * n, n)
        return t.clone()

    fields = {}
    for k, v in vars(state).items():
        if k == "pages":
            fields[k] = type(v)(**{n: None if t is None else part(n, t)
                                   for n, t in vars(v).items()})
        else:
            fields[k] = part(k, v) if isinstance(v, torch.Tensor) else v
    return type(state)(**fields)
