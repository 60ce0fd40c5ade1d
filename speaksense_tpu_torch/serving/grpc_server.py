"""gRPC bidi-streaming ASR server (port 7300).

The port's own copy of `speaksense_tpu/serving/grpc_server.py`,
with the same names and behaviour.

Wire-compatible with the reference's tonic service (`service Asr { rpc
Transcribe(stream) returns (stream) }`, the reference's proto/asr.proto:6-8;
server bootstrap at src/grpc/server.rs): same proto, same go-micro-style etcd
registration metadata, so existing clients and service discovery work
unchanged.

Differences by design:
- handlers are async-generator based (grpc.aio), engine work runs in a worker
  thread pool so many streams share the engine's batches;
- etcd being down does NOT prevent startup (the reference hard-fails,
  src/main.rs:79 — SURVEY.md §7 step 7 calls for tolerating absence).
"""

from __future__ import annotations

import asyncio
import logging
import socket
import uuid

import grpc

from speaksense_tpu_torch.asr import AsrEngine
from speaksense_tpu_torch.auth.types import AuthError, Permission
from speaksense_tpu_torch.serving.pb import asr_pb2
from speaksense_tpu_torch.serving.stream import (
    StreamEvent, StreamSession, UnsupportedStreamFormat,
)

log = logging.getLogger(__name__)

SERVICE_PATH = "/asr.Asr/Transcribe"


def _event_to_response(ev: StreamEvent) -> asr_pb2.TranscribeResponse:
    return asr_pb2.TranscribeResponse(
        end=ev.end,
        text=ev.text.encode("utf-8"),
        device_id=ev.device_id,
        segments=[asr_pb2.Segment(start=s, end=e, text=t.encode("utf-8"))
                  for s, e, t in ev.segments],
    )


class AsrService:
    """The Asr service implementation (reference AsrService,
    src/grpc/handlers/asr.rs:20-138)."""

    def __init__(self, engine: AsrEngine, language: str = "zh", denoise: bool = True,
                 executor=None, max_inflight: int | None = None,
                 auth=None, require_auth: bool = False,
                 condition: bool = True):
        self.engine = engine
        self.language = language
        self.denoise = denoise
        # previous-text conditioning toggle (whisper.cpp no_context; the
        # reference serves no_context=false, i.e. condition=True). On the
        # default pool condition=True does nothing: the engine conditions a
        # pooled chunk only on a pool built with max_prompt > 16
        # (`--slot-prompt 64`; the gate of asr/engine.py's
        # submit_stream_chunk, as JAX asr/engine.py:1087-1088), and the
        # default prompt budget is 16 tokens, plain SOT
        self.condition = condition
        # OPTIONAL bearer auth on streams (off by default: the reference's
        # gRPC front door is unauthenticated, SURVEY §1 L4). With an Auth
        # service attached, an `authorization: Bearer <key>` metadata entry
        # is verified against the same key store as REST; require_auth=True
        # additionally rejects keyless streams. Authenticated streams get
        # served-work usage accounting (total_tokens/total_audio_seconds).
        self.auth = auth
        self.require_auth = require_auth
        # chunks one stream may keep decoding concurrently while earlier
        # results are still being settled/serialized (session-level
        # pipelining; only effective on engines with nonblocking submission)
        if max_inflight is None:
            import os

            max_inflight = int(os.environ.get("SPEAKSENSE_MAX_INFLIGHT", "8"))
        self.max_inflight = max(1, max_inflight)
        # Dedicated pool for blocking session work: a feed() blocks its
        # thread on the decode future, so the pool must hold >= one thread
        # per concurrent stream or streams queue BEHIND the thread pool
        # instead of inside the batching engine (asyncio.to_thread's default
        # pool caps at ~32, which would halve 64-slot occupancy).
        if executor is None:
            import os
            from concurrent.futures import ThreadPoolExecutor

            # pipelining runs TWO concurrent executor calls per stream
            # (ingest + settle), so 64 streams need up to 128 threads +
            # headroom — 96 measured as "plenty" pre-pipelining but would
            # queue settles behind the pool at full occupancy
            executor = ThreadPoolExecutor(
                max_workers=int(os.environ.get("SPEAKSENSE_STREAM_THREADS", "160")),
                thread_name_prefix="stream-session")
        self._executor = executor

    async def Transcribe(self, request_iterator, context):
        # Session-level pipelining: an ingest task reads inbound messages
        # and SUBMITS each complete chunk's decode without waiting
        # (StreamSession.ingest), while this generator settles results in
        # order and streams the responses. A backlogged stream thereby
        # keeps up to max_inflight chunks decoding concurrently in the slot
        # pool instead of idling a slot for one host round trip per chunk;
        # engines without nonblocking submission decode inline during
        # ingest, preserving the old sequential behavior exactly.
        loop = asyncio.get_running_loop()
        api_key: str | None = None
        auth_header: str | None = None
        if self.auth is not None:
            meta = dict(context.invocation_metadata() or ())
            header = meta.get("authorization")
            if header:
                try:
                    await loop.run_in_executor(
                        None, self.auth.verify_api_key, header,
                        Permission.TRANSCRIBE)
                    api_key = header.split(" ")[-1]
                    auth_header = header
                except AuthError as e:
                    await context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
            elif self.require_auth:
                await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                                    "missing authorization metadata")
            # else: keyless stream allowed (reference wire compat) — no
            # usage accounting
        session: StreamSession | None = None
        q: asyncio.Queue = asyncio.Queue(maxsize=self.max_inflight)

        async def recheck_auth():
            """Per-chunk auth re-verification (matches REST's per-request
            accounting — the reference's src/auth/service.rs:41-90 charges
            the per-minute limiter and stats on EVERY request): each decode
            chunk re-runs the full verify chain, so a key revoked or expired
            mid-stream terminates the stream and a stream is rate-limited
            per chunk of served work, not once at open. Raises AuthError."""
            await loop.run_in_executor(
                None, self.auth.verify_api_key, auth_header,
                Permission.TRANSCRIBE)

        async def ingest():
            nonlocal session
            try:
                async for req in request_iterator:
                    if session is None:
                        fmt = asr_pb2.AudioFormat.Name(req.type) \
                            if req.type in asr_pb2.AudioFormat.values() else "UNKNOWN"
                        session = StreamSession(self.engine, device_id=req.device_id,
                                                language=self.language,
                                                denoise=self.denoise,
                                                audio_format=fmt,
                                                condition=self.condition)
                    pendings = await loop.run_in_executor(
                        self._executor, session.ingest, req.audio, req.device_id)
                    for p in pendings:
                        if auth_header is not None:
                            try:
                                await recheck_auth()
                            except AuthError as e:
                                await q.put(("auth_error", e))
                                return
                        await q.put(("chunk", p))  # blocks at max_inflight
                    if req.end == 1:
                        await q.put(("finish", None))
                        return
                await q.put(("eos", None))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                await q.put(("error", e))

        ingest_task = asyncio.create_task(ingest())
        try:
            while True:
                kind, payload = await q.get()
                if kind == "chunk":
                    events = await loop.run_in_executor(
                        self._executor, session.settle, payload)
                    for ev in events:
                        yield _event_to_response(ev)
                elif kind == "finish":
                    for ev in await loop.run_in_executor(self._executor, session.finish):
                        yield _event_to_response(ev)
                    return
                elif kind == "eos":
                    # client half-closed WITHOUT end=1: deliberate reference
                    # parity — the original's ingest loop just ends, the
                    # buffered tail (< one chunk) is dropped and no end
                    # marker is sent (handlers/asr.rs:169-265; only end==1
                    # reaches the flush at :247). Clients wanting the tail
                    # transcribed must send end=1, as the example client
                    # does (asr_client.rs:178).
                    return
                else:
                    raise payload
        except asyncio.CancelledError:
            log.info("stream cancelled by client")
            raise
        except AuthError as e:
            # mid-stream revocation/expiry/rate-limit (recheck_auth):
            # RESOURCE_EXHAUSTED for rate limits (the gRPC idiom — the
            # stream must reconnect within its per-minute budget);
            # everything else UNAUTHENTICATED, matching the open-time check
            code = (grpc.StatusCode.RESOURCE_EXHAUSTED
                    if e.kind == AuthError.RATE_LIMITED
                    else grpc.StatusCode.UNAUTHENTICATED)
            log.warning("stream terminated mid-stream by auth: %s", e)
            await context.abort(code, str(e))
        except UnsupportedStreamFormat as e:
            log.warning("rejected stream: %s", e)
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:
            log.error("stream error: %s", e, exc_info=True)
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            ingest_task.cancel()
            if api_key and session is not None and (
                    session.usage_tokens or session.usage_audio_seconds):
                try:
                    await loop.run_in_executor(
                        None, self.auth.record_usage, api_key,
                        session.usage_tokens, session.usage_audio_seconds)
                except Exception as e:  # accounting must not mask stream errors
                    log.error("stream usage accounting failed: %s", e)

    def handler(self) -> grpc.GenericRpcHandler:
        rpc = grpc.stream_stream_rpc_method_handler(
            self.Transcribe,
            request_deserializer=asr_pb2.TranscribeRequest.FromString,
            response_serializer=asr_pb2.TranscribeResponse.SerializeToString,
        )
        return grpc.method_handlers_generic_handler("asr.Asr", {"Transcribe": rpc})


def local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 80))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


class GrpcServer:
    """Bind, register in etcd (go-micro layout), heartbeat, serve
    (reference GrpcServer, src/grpc/server.rs:22-99)."""

    def __init__(self, engine: AsrEngine, port: int = 7300, registry=None,
                 service_name: str = "asr", language: str = "zh", denoise: bool = True,
                 auth=None, require_auth: bool = False, condition: bool = True):
        self.engine = engine
        self.port = port
        self.registry = registry
        self.service_name = service_name
        self.node_id = f"{service_name}-{uuid.uuid4()}"
        self.language = language
        self.denoise = denoise
        self.auth = auth
        self.require_auth = require_auth
        self.condition = condition
        self._server: grpc.aio.Server | None = None

    def service_info(self) -> dict:
        """go-micro compatible registration payload (server.rs:48-69)."""
        addr = f"{local_ip()}:{self.port}"
        return {
            "name": self.service_name,
            "version": "latest",
            "metadata": {
                "broker": "http", "protocol": "grpc", "registry": "etcd",
                "server": "grpc", "transport": "grpc",
            },
            "endpoints": [],
            "nodes": [{
                "id": self.node_id,
                "address": addr,
                "metadata": {"broker": "http", "protocol": "grpc", "registry": "etcd",
                             "server": "grpc", "transport": "grpc"},
            }],
        }

    async def start(self) -> None:
        self._server = grpc.aio.server()
        svc = AsrService(self.engine, language=self.language, denoise=self.denoise,
                         auth=self.auth, require_auth=self.require_auth,
                         condition=self.condition)
        self._server.add_generic_rpc_handlers((svc.handler(),))
        bound = self._server.add_insecure_port(f"0.0.0.0:{self.port}")
        if bound == 0:
            raise OSError(f"failed to bind gRPC port {self.port}")
        self.port = bound
        if self.registry is not None:
            try:
                await self.registry.register(self.service_info())
                await self.registry.start_heartbeat()
            except Exception as e:
                log.warning("etcd registration failed (continuing without): %s", e)
        await self._server.start()
        log.info("gRPC ASR server listening on :%d", self.port)

    async def wait(self) -> None:
        if self._server:
            await self._server.wait_for_termination()

    async def stop(self, grace: float = 5.0) -> None:
        if self.registry is not None:
            try:
                await self.registry.stop_heartbeat()
                await self.registry.deregister()
            except Exception as e:
                log.warning("etcd deregistration failed: %s", e)
        if self._server:
            await self._server.stop(grace)
