"""REST API (port 7200) — aiohttp implementation of the reference's axum
router (the reference's src/web/): same routes, payloads, and response
envelopes:

  POST /asr/transcribe           HttpResponse{code,message,body} envelope
  POST /auth/api-keys            ApiResponse{success,data,error}, 201
  DELETE /auth/api-keys/{key}
  GET  /auth/api-keys/{key}/stats
  GET  /auth/api-keys/{key}/usage
  POST /schedule/tasks           raw TaskConfig JSON, 201
  GET  /schedule/tasks/{id}
  GET  /schedule/tasks/{id}/status
  POST /schedule/tasks/{id}/priority   (pending-only)
  GET  /schedule/tasks/stats
  POST /callback/http            dev echo sink (web/handlers/callback_test.rs)

Fixes over the reference:
- /schedule/tasks/stats DROPS pagination and aggregates over all tasks —
  the reference's Path extractor made the route unusable (SURVEY.md §7
  quirks, web/handlers/schedule.rs:148), and status counts are global by
  nature; clients passing ?index=&size= get the same global counts.
- /auth/api-keys* requires an Admin bearer key (the reference leaves key
  management wholly unauthenticated — any peer could mint an Admin key).

The port's own copy of `speaksense_tpu/serving/rest.py`, with the same
names, routes, envelopes and fixes. One difference: aiohttp is imported
inside `build_app`, `start_server` and the handlers, not with the module,
so that `AppContext` and `main.build_context` (the task queue, stores and
auth) import where aiohttp is missing, as on the GPU image; building the
app there raises ImportError.
"""

from __future__ import annotations

import asyncio
import functools
import logging
from dataclasses import dataclass
from typing import TYPE_CHECKING

from speaksense_tpu_torch.auth import Auth, AuthError, Permission, RateLimit
from speaksense_tpu_torch.schedule.manager import TaskManager
from speaksense_tpu_torch.schedule.types import (
    CallbackType, PathType, TaskConfig, TaskParams, TaskPriority, TaskType,
    TranscribeParams,
)

if TYPE_CHECKING:
    from aiohttp import web

log = logging.getLogger(__name__)


@dataclass
class AppContext:
    """Shared handler state (reference AppContext, src/lib.rs:16-19)."""

    auth: Auth
    task_manager: TaskManager


def _web():
    """aiohttp's `web`, imported on first use (ImportError without aiohttp)."""
    from aiohttp import web

    return web


@functools.cache
def _ctx_key():
    """The application key under which handlers find the AppContext."""
    return _web().AppKey("ctx", AppContext)


def _api_ok(data, status=200):
    return _web().json_response({"success": True, "data": data, "error": None}, status=status)


def _api_err(error: str, status=400):
    return _web().json_response({"success": False, "data": None, "error": error}, status=status)


def _http_envelope(code: int, message: str, body, status=200):
    return _web().json_response({"code": code, "message": message, "body": body}, status=status)


# ---------------------------------------------------------------- /asr

async def asr_transcribe(request: web.Request) -> web.Response:
    """Mirror of src/web/handlers/asr.rs:48-108."""
    ctx: AppContext = request.app[_ctx_key()]
    auth_header = request.headers.get("Authorization")
    try:
        await asyncio.to_thread(ctx.auth.verify_api_key, auth_header, Permission.TRANSCRIBE)
    except AuthError as e:
        return _http_envelope(401, "Authentication failed", str(e), status=401)

    try:
        req = await request.json()
        config = TaskConfig(
            task_type=TaskType.TRANSCRIBE,
            input_path=req["path"],
            path_type=PathType(req.get("path_type", "Url")),
            callback_type=CallbackType.http(req["callback_url"]),
            params=TaskParams.transcribe(TranscribeParams(
                language=req.get("language"),
                speaker_diarization=bool(req.get("speaker_diarization", False)),
                emotion_recognition=bool(req.get("emotion_recognition", False)),
                filter_dirty_words=bool(req.get("filter_dirty_words", False)),
            )),
            priority=TaskPriority.NORMAL,
            retry_count=0,
            max_retries=3,
            timeout=None,
            # completion-time usage accounting is attributed to this key
            api_key=auth_header.split(" ")[-1] if auth_header else None,
        )
    except (KeyError, ValueError, TypeError) as e:
        return _http_envelope(400, "Invalid request", str(e), status=400)

    try:
        task = await asyncio.to_thread(ctx.task_manager.create_task, config)
    except Exception as e:
        log.error("failed to create task: %s", e)
        return _http_envelope(500, "Failed to create task", str(e), status=500)
    return _http_envelope(0, "Task added successfully", task.id)


# ---------------------------------------------------------------- /auth

async def _require_admin(request: web.Request) -> web.Response | None:
    """Key management requires an Admin bearer key. DELIBERATE divergence
    from the reference, which leaves /auth/api-keys wholly unauthenticated
    (web/handlers/auth.rs has no guard) — any network peer could mint an
    Admin key or revoke the real one. The startup bootstrap logs an admin
    key precisely so there is always a credential to manage keys with."""
    ctx: AppContext = request.app[_ctx_key()]
    try:
        await asyncio.to_thread(ctx.auth.verify_api_key,
                                request.headers.get("Authorization"),
                                Permission.ADMIN)
    except AuthError as e:
        return _api_err(f"Authentication failed: {e}", status=401)
    return None


async def create_api_key(request: web.Request) -> web.Response:
    if (denied := await _require_admin(request)) is not None:
        return denied
    ctx: AppContext = request.app[_ctx_key()]
    try:
        req = await request.json()
        permissions = [Permission(p) for p in req["permissions"]]
        rate_limit = RateLimit.from_json(req["rate_limit"])
        info = await asyncio.to_thread(
            ctx.auth.create_api_key, req["name"], permissions, rate_limit,
            req.get("expires_in_days"))
    except (KeyError, ValueError, TypeError) as e:
        return _api_err(str(e), status=400)
    return _api_ok({"key_info": info.to_json()}, status=201)


async def revoke_api_key(request: web.Request) -> web.Response:
    if (denied := await _require_admin(request)) is not None:
        return denied
    ctx: AppContext = request.app[_ctx_key()]
    await asyncio.to_thread(ctx.auth.revoke_api_key, request.match_info["api_key"])
    return _api_ok(None)


async def get_key_stats(request: web.Request) -> web.Response:
    if (denied := await _require_admin(request)) is not None:
        return denied
    ctx: AppContext = request.app[_ctx_key()]
    try:
        stats = await asyncio.to_thread(ctx.auth.get_key_stats, request.match_info["api_key"])
    except KeyError as e:
        return _api_err(str(e), status=404)
    return _api_ok(stats.to_json())


async def get_key_usage(request: web.Request) -> web.Response:
    if (denied := await _require_admin(request)) is not None:
        return denied
    ctx: AppContext = request.app[_ctx_key()]
    try:
        report = await asyncio.to_thread(
            ctx.auth.get_key_usage_report, request.match_info["api_key"])
    except KeyError as e:
        return _api_err(str(e), status=404)
    return _api_ok(report.to_json())


# ---------------------------------------------------------------- /schedule

async def create_task(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[_ctx_key()]
    try:
        body = await request.json()
        # api_key is SERVER-assigned attribution (set by authenticated
        # /asr/transcribe): this route is unauthenticated (reference
        # parity), so a client-supplied value would forge usage counters
        # onto someone else's key — drop it
        if isinstance(body, dict):
            body.pop("api_key", None)
        config = TaskConfig.from_json(body)
        task = await asyncio.to_thread(ctx.task_manager.create_task, config)
    except Exception as e:
        log.error("failed to create task: %s", e)
        return _api_err(str(e), status=400)
    return _api_ok(task.to_public_json(), status=201)


async def get_task(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[_ctx_key()]
    task = await asyncio.to_thread(ctx.task_manager.get_task, request.match_info["task_id"])
    if task is None:
        return _api_err("Task not found", status=404)
    return _api_ok(task.to_public_json())


async def get_task_status(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[_ctx_key()]
    status = await asyncio.to_thread(
        ctx.task_manager.get_task_status, request.match_info["task_id"])
    if status is None:
        return _api_err("Task not found", status=404)
    return _api_ok(status.to_json())


async def update_task_priority(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[_ctx_key()]
    try:
        req = await request.json()
        priority = TaskPriority(req["priority"])
    except (KeyError, ValueError, TypeError) as e:
        return _api_err(str(e), status=400)
    ok = await asyncio.to_thread(
        ctx.task_manager.update_task_priority, request.match_info["task_id"], priority)
    if not ok:
        return _api_err("task not found or not pending", status=400)
    return _api_ok(None)


async def get_task_stats(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[_ctx_key()]
    stats = await asyncio.to_thread(ctx.task_manager.get_task_stats)
    return _api_ok(dict(stats))


# ---------------------------------------------------------------- /callback

async def http_callback_echo(request: web.Request) -> web.Response:
    payload = await request.json()
    log.info("received callback: %s", payload)
    return _web().json_response({})


# ------------------------------------------------------- /metrics, /health
# (additions over the reference, which has neither — SURVEY.md §5)

async def metrics_endpoint(request: web.Request) -> web.Response:
    from speaksense_tpu_torch.utils.metrics import REGISTRY

    return _web().Response(text=REGISTRY.render_prometheus(),
                        content_type="text/plain")


async def health_endpoint(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[_ctx_key()]
    try:
        await asyncio.to_thread(ctx.task_manager.get_task_stats)
        return _web().json_response({"status": "ok"})
    except Exception as e:
        return _web().json_response({"status": "unhealthy", "error": str(e)}, status=503)


# ---------------------------------------------------------------- app

def build_app(ctx: AppContext) -> web.Application:
    from aiohttp import web

    app = web.Application()
    app[_ctx_key()] = ctx
    app.router.add_post("/asr/transcribe", asr_transcribe)
    app.router.add_post("/auth/api-keys", create_api_key)
    app.router.add_delete("/auth/api-keys/{api_key}", revoke_api_key)
    app.router.add_get("/auth/api-keys/{api_key}/stats", get_key_stats)
    app.router.add_get("/auth/api-keys/{api_key}/usage", get_key_usage)
    # NOTE: /schedule/tasks/stats must be registered before /{task_id}
    app.router.add_get("/schedule/tasks/stats", get_task_stats)
    app.router.add_post("/schedule/tasks", create_task)
    app.router.add_get("/schedule/tasks/{task_id}", get_task)
    app.router.add_get("/schedule/tasks/{task_id}/status", get_task_status)
    app.router.add_post("/schedule/tasks/{task_id}/priority", update_task_priority)
    app.router.add_post("/callback/http", http_callback_echo)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/health", health_endpoint)
    return app


async def start_server(ctx: AppContext, host: str = "0.0.0.0", port: int = 7200):
    """Start and return the aiohttp runner (reference web::start_server,
    src/web/mod.rs:13-21)."""
    from aiohttp import web

    app = build_app(ctx)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    log.info("REST server listening on %s:%d", host, port)
    return runner
