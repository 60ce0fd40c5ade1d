"""The port's gRPC front door against the JAX package's: both `GrpcServer`s
run on ephemeral loopback ports and get the same bidi streams; the
responses (or the status code and details that end a stream) are equal.
Covered: end=1, a half-close without it, empty audio, an unsupported
format, the optional, required and invalid-key auth modes, a key revoked
mid-stream, the per-minute limit charged per chunk with the usage it meters,
and one stream through the tiny slot pool on shared weights. Each side has
its own `FakeAsrEngine` and key store where the engine is not the point."""

import asyncio
import base64
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import grpc

from test_torch_schedule import PACKAGES


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(
        grpc=importlib.import_module(f"{name}.serving.grpc_server"),
        pb=importlib.import_module(f"{name}.serving.pb.asr_pb2"),
        fake=importlib.import_module(f"{name}.asr.fake"),
        auth=importlib.import_module(f"{name}.auth"),
        sqlite=importlib.import_module(f"{name}.storage.sqlite"))


def _pcm_b64(seconds: float, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return base64.b64encode((rng.standard_normal(int(16000 * seconds)) * 800)
                            .astype(np.int16).tobytes())


async def _requests(pb, spec):
    """The requests of `spec`; at a None, hold the stream open without
    sending more."""
    for item in spec:
        if item is None:
            await asyncio.Event().wait()
        fmt, end, audio, dev = item
        yield pb.TranscribeRequest(type=getattr(pb, fmt), end=end, audio=audio, device_id=dev)


STREAMS = {
    "end1": [("PCM", 0, _pcm_b64(3.0, 1), "dev-42"), ("PCM", 0, _pcm_b64(3.0, 2), ""),
             ("PCM", 1, _pcm_b64(1.0, 3), "")],
    "half_close": [("PCM", 0, _pcm_b64(6.5, 4), "dev-1")],
    "empty_final": [("PCM", 1, b"", "")],
    "unsupported_format": [("MP3", 0, base64.b64encode(b"ID3\x04" + bytes(4000)), "")],
    "aac_tag_with_pcm": [("AAC", 1, _pcm_b64(2.0, 5), "")],
}
SIX = [("PCM", 0, _pcm_b64(6.0, 6), ""), ("PCM", 1, _pcm_b64(1.0, 7), "")]
CHUNKS = [("PCM", 0, _pcm_b64(5.5, 8), ""), ("PCM", 0, _pcm_b64(5.5, 9), "")]
# A stream the server ends while the client still writes may end INTERNAL on
# the client ("Internal error from Core") instead of with the server's
# status, a race of the transport. Where the server refuses, the client
# sends what the refusal needs and then holds the stream open (None).
AUTH = {
    # (auth mode, key to send, requests)
    "optional_keyless": ("optional", None, SIX),
    "optional_with_key": ("optional", "admin", SIX),
    "required_keyless": ("required", None, [None]),
    "invalid_key": ("optional", "key-nope", [None]),
    "rate_limit_per_chunk": ("optional", "tiny", CHUNKS + [None]),
}


async def _call(P, port, requests, metadata=None):
    """Run one stream; returns its responses or its status code and details."""
    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.stream_stream(P.grpc.SERVICE_PATH,
                                request_serializer=P.pb.TranscribeRequest.SerializeToString,
                                response_deserializer=P.pb.TranscribeResponse.FromString)(
            requests, metadata=metadata)
        try:
            return [(r.end, r.text.decode(), r.device_id,
                     [(s.start, s.end, s.text.decode()) for s in r.segments])
                    async for r in call]
        except grpc.aio.AioRpcError as e:
            return (e.code().name, e.details())


async def _with_server(P, engine, fn, **kw):
    server = P.grpc.GrpcServer(engine, port=0, registry=None, language="en",
                               denoise=False, **kw)
    await server.start()
    try:
        return await fn(server.port)
    finally:
        await server.stop(grace=0.1)


def _keys(P, tmp):
    """A key store with the admin key and a key of 2 requests a minute."""
    store = P.sqlite.SqliteKeyStorage(tmp)
    auth = P.auth.Auth(store, store)
    keys = {"admin": auth.initialize_admin_key().key,
            "tiny": auth.create_api_key("tiny", [P.auth.Permission.TRANSCRIBE],
                                        P.auth.RateLimit(requests_per_minute=2)).key,
            "key-nope": "key-nope"}
    return auth, store, keys


@pytest.mark.parametrize("case", sorted(STREAMS) + sorted(AUTH))
def test_stream_matches_jax(case, tmp_path):
    outcomes = []
    for name in PACKAGES:
        P = _pkg(name)
        auth, store, keys = _keys(P, tmp_path / f"{name}.sqlite")
        mode, key, spec = AUTH.get(case, (None, None, STREAMS.get(case)))
        meta = (("authorization", f"Bearer {keys[key]}"),) if key else None
        try:
            got = asyncio.run(_with_server(
                P, P.fake.FakeAsrEngine(),
                lambda port: _call(P, port, _requests(P.pb, spec), meta),
                auth=auth if mode else None, require_auth=mode == "required"))
            stats = auth.get_key_stats(keys["admin" if key != "tiny" else "tiny"]).to_json()
        finally:
            store.close()
        # the usage of a stream the server aborts is written after the abort
        # and may land after the server stopped: compare it for streams that
        # end normally, the requests charged for every stream
        metered = (("total_requests", "total_tokens", "total_audio_seconds")
                   if isinstance(got, list) else ("total_requests",))
        outcomes.append((got, {k: stats[k] for k in metered}))
    want, got = outcomes
    assert got == want
    expected = {"end1": list, "half_close": list, "empty_final": list,
                "unsupported_format": "INVALID_ARGUMENT", "aac_tag_with_pcm": list,
                "optional_keyless": list, "optional_with_key": list,
                "required_keyless": "UNAUTHENTICATED", "invalid_key": "UNAUTHENTICATED",
                "rate_limit_per_chunk": "RESOURCE_EXHAUSTED"}[case]
    if expected is list:
        assert isinstance(got[0], list)
        assert case == "half_close" or got[0][-1][0] == 1
    else:
        assert got[0][0] == expected, got
    if case == "optional_with_key":
        assert got[1]["total_requests"] == 2 and got[1]["total_audio_seconds"] > 0


def test_key_revoked_mid_stream_matches_jax(tmp_path):
    """A key revoked after the first chunk's response ends the stream
    UNAUTHENTICATED at the next chunk's re-check, on both servers."""
    outcomes = []
    for name in PACKAGES:
        P = _pkg(name)
        auth, store, keys = _keys(P, tmp_path / f"{name}.sqlite")

        async def run(port):
            got_first = asyncio.Event()
            responses = []

            async def gen():
                yield P.pb.TranscribeRequest(type=P.pb.PCM, audio=_pcm_b64(5.5, 10))
                await asyncio.wait_for(got_first.wait(), 10)
                auth.revoke_api_key(keys["admin"])
                yield P.pb.TranscribeRequest(type=P.pb.PCM, audio=_pcm_b64(5.5, 11))
                await asyncio.Event().wait()  # the refusal ends the stream

            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                call = ch.stream_stream(
                    P.grpc.SERVICE_PATH,
                    request_serializer=P.pb.TranscribeRequest.SerializeToString,
                    response_deserializer=P.pb.TranscribeResponse.FromString)(
                    gen(), metadata=(("authorization", f"Bearer {keys['admin']}"),))
                try:
                    async for r in call:
                        responses.append(r.text.decode())
                        got_first.set()
                except grpc.aio.AioRpcError as e:
                    return responses, e.code().name, e.details()
            return responses, None, None

        try:
            outcomes.append(asyncio.run(_with_server(P, P.fake.FakeAsrEngine(), run,
                                                     auth=auth)))
        finally:
            store.close()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][1:] == ("UNAUTHENTICATED", "API key suspended")


def test_stream_through_slot_pool_matches_jax():
    """One stream of 10.5 s through each package's slot pool of 2 slots on
    the same tiny weights (ladder neutralized): the same responses."""
    from speaksense_tpu.asr.engine import WhisperEngine as JEngine
    from speaksense_tpu.config import EngineConfig
    from speaksense_tpu.models import whisper as JW
    from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
    from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
    from speaksense_tpu_torch.models import whisper as TW
    from speaksense_tpu_torch.models.tokenizer import Tokenizer

    dims = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                          n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                          n_text_head=4, n_text_layer=2)
    params = JW.init_params_np(dims, seed=0)
    cfg = EngineConfig(compute_dtype="float32", compression_ratio_thold=1e9,
                       logprob_thold=-1e9, entropy_thold=-1.0)
    engines = (JEngine(params, dims, JTokenizer.synthetic(dims.n_vocab), config=cfg),
               TEngine.from_jax_params(params, TW.WhisperDims(**dims.__dict__),
                                       Tokenizer.synthetic(dims.n_vocab), config=cfg,
                                       device="cpu"))
    spec = [("PCM", 0, _pcm_b64(5.2, 12), "dev-7"), ("PCM", 0, _pcm_b64(4.3, 13), ""),
            ("PCM", 1, _pcm_b64(1.0, 14), "")]
    outcomes = []
    for name, engine in zip(PACKAGES, engines):
        P = _pkg(name)
        engine.enable_slot_serving(n_slots=2, t_mel=512, max_new=8)
        try:
            outcomes.append(asyncio.run(_with_server(
                P, engine, lambda port: _call(P, port, _requests(P.pb, spec)))))
            pool = engine._slot_server.pool
            assert pool.admit_rows >= 2 and pool.n_active == 0
        finally:
            engine.disable_slot_serving()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][-1][0] == 1 and any(r[1] for r in outcomes[1])


def test_service_info_is_go_micro():
    """The etcd registration payload has the JAX server's shape."""
    J, P = (_pkg(n) for n in PACKAGES)
    want = J.grpc.GrpcServer(None, port=7300).service_info()
    got = P.grpc.GrpcServer(None, port=7300).service_info()
    for info in (want, got):
        info["nodes"][0]["id"] = info["nodes"][0]["id"].split("-")[0]
    assert got == want
