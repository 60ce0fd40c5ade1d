"""Streaming transcription session logic (transport-independent).

The port's own copy of `speaksense_tpu/serving/stream.py`, with the same
names and behaviour; its host denoise (engines without device denoise) is
the port's numpy chain in `speaksense_tpu_torch/audio/dsp.py`. Behavior
mirror of the reference's src/grpc/handlers/asr.rs:
- StreamContext time mapping (:26-60): per-chunk segment times remapped to
  absolute stream milliseconds with a 5 s block base and monotonic clamping;
- process_text (:69-137): diff-based extraction of only-new text between
  successive overlapping-chunk transcriptions (prefix diff, sentence-split
  diff, last-segment containment), preserving trailing punctuation;
- chunk accumulation (:14-18, :187-231): the reference's constants are in
  BYTES of s16 PCM — CHUNK_SIZE 160000 bytes = 5 s, and the kept overlap is
  16000 bytes = 0.5 s (the comments say 10 s / 1 s; the byte unit is the
  actual behavior, SURVEY.md §7 quirks). Both are configurable here.

Keeping this free of gRPC lets the same session drive gRPC, websockets, or
tests directly.
"""

from __future__ import annotations

import base64
import binascii
import logging
from dataclasses import dataclass, field

import numpy as np

from speaksense_tpu_torch.asr import AsrEngine, AsrParams, TranscribeSegment

log = logging.getLogger(__name__)

SAMPLE_RATE = 16_000
CHUNK_BYTES = SAMPLE_RATE * 10      # 160000 B of s16 = 5 s of audio
OVERLAP_BYTES = SAMPLE_RATE         # 16000 B = 0.5 s kept between chunks
BLOCK_SECONDS = 5.0                 # block base used for absolute times

_SENTENCE_ENDS = "。！？.!?"


class UnsupportedStreamFormat(ValueError):
    """Raised when a stream's first bytes really are an encoded container the
    streaming path cannot decode (the gRPC transport maps this to
    INVALID_ARGUMENT instead of the reference's behavior of transcribing
    garbage — the reference's proto/asr.proto advertises AAC/MP3/... but the
    handler assumes PCM16)."""


# container magics for formats the streaming path cannot decode. The tag
# alone is NOT trusted: the reference example client sends type=0 (AAC) with
# raw PCM16 (asr_client.rs:176), so only reject when the BYTES are actually
# an encoded container.
_MAGIC_SNIFFS = {
    "MP3": (b"ID3",),
    "OGG": (b"OggS",),
    "OPUS": (b"OggS",),
    "FLAC": (b"fLaC",),
    "AMR": (b"#!AMR",),
}


def _looks_encoded(fmt: str, head: bytes) -> bool:
    if fmt == "AAC":  # ADTS syncword
        return len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xF6) == 0xF0
    return any(head.startswith(m) for m in _MAGIC_SNIFFS.get(fmt, ()))


def _strip_wav_header(buf: bytes) -> bytes | None:
    """Validate + strip a RIFF/WAVE header: require 16 kHz mono s16 (the
    streaming contract), return the PCM payload after the data chunk header.
    Returns None when the header is INCOMPLETE (chunk table spans inbound
    packets — e.g. a LIST/INFO chunk pushes fmt/data past the first
    message): the caller buffers more bytes and retries. Raises
    UnsupportedStreamFormat on other encodings/rates or a header that is
    still unresolved after 64 KiB (malformed, not merely split)."""
    if len(buf) < 44:
        return None  # too short to judge; wait for more bytes
    pos = 12  # past "RIFF" size "WAVE"
    data_off = None
    fmt = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        size = int.from_bytes(buf[pos + 4 : pos + 8], "little")
        if cid == b"fmt ":
            fmt = buf[pos + 8 : pos + 8 + size]
        elif cid == b"data":
            data_off = pos + 8
            break
        pos += 8 + size + (size & 1)
    if data_off is not None and (fmt is None or len(fmt) < 16):
        # data chunk reached without a usable fmt chunk before it: more
        # bytes can never fix this — reject instead of buffering forever
        raise UnsupportedStreamFormat("malformed WAV header in stream")
    if fmt is None or data_off is None or len(fmt) < 16:
        if pos > 65536 or len(buf) > 65536:
            raise UnsupportedStreamFormat("malformed WAV header in stream")
        return None  # header continues in a later packet
    audio_fmt = int.from_bytes(fmt[0:2], "little")
    channels = int.from_bytes(fmt[2:4], "little")
    rate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if (audio_fmt, channels, rate, bits) != (1, 1, SAMPLE_RATE, 16):
        raise UnsupportedStreamFormat(
            f"streaming WAV must be 16 kHz mono s16 PCM; got fmt={audio_fmt} "
            f"ch={channels} rate={rate} bits={bits} — transcode client-side "
            f"or use the REST batch API (ffmpeg handles any format)")
    return buf[data_off:]


class StreamContext:
    """Absolute-time stitching state (handlers/asr.rs:26-60).

    block_seconds must equal the session's chunk duration — StreamSession
    derives it from chunk_bytes so a caller changing the chunk size doesn't
    ALSO desync the base the way the reference's fixed 5 s constant would.

    DELIBERATE reference-quirk parity: the base advances by the FULL chunk
    duration per block while the session's real audio position advances by
    chunk - overlap (the overlap tail is re-fed, handlers/asr.rs:231), so
    absolute timestamps drift ahead of true stream time by overlap seconds
    per block — exactly as the reference's do. Clients that built around
    the original's timestamps see identical values; set overlap_bytes=0
    for drift-free absolute times."""

    def __init__(self, block_seconds: float = BLOCK_SECONDS):
        self.block_seconds = block_seconds
        self.block_index = 0
        self.last_text = ""
        self.last_end_time = 0.0  # seconds

    def calculate_segment_time(self, seg_start: float, seg_end: float) -> tuple[int, int]:
        base = self.block_index * self.block_seconds
        abs_start = int((base + seg_start) * 1000.0)
        abs_end = int((base + seg_end) * 1000.0)
        last_end_ms = int(self.last_end_time * 1000.0)
        if abs_start < last_end_ms:  # monotonic clamp
            diff = last_end_ms - abs_start
            abs_start = last_end_ms
            abs_end += diff
        self.last_end_time = abs_end / 1000.0
        return abs_start, abs_end

    def next_block(self) -> None:
        self.block_index += 1


def process_text(new_text: str, last_text: str,
                 segments: list[TranscribeSegment]) -> str | None:
    """Extract only-new text between consecutive chunk transcriptions
    (handlers/asr.rs:69-137). Returns None when nothing new."""
    if not last_text:
        return new_text

    if segments:
        last_segment = segments[-1]
        if last_segment.text and last_segment.text not in last_text:
            return last_segment.text

    if len(new_text) > len(last_text) and new_text.startswith(last_text):
        added = new_text[len(last_text):]
        if added.strip():
            return added.strip()

    if len(new_text) > len(last_text) * 2 or len(last_text) > len(new_text) * 2:
        return new_text

    if new_text != last_text:
        new_sentences = [s for s in _split_sentences(new_text) if s.strip()]
        last_sentences = [s for s in _split_sentences(last_text) if s.strip()]
        trailing = new_text[-1] if new_text and new_text[-1] in _SENTENCE_ENDS else ""
        if len(new_sentences) > len(last_sentences):
            new_content = "".join(new_sentences[len(last_sentences):]).strip()
            if new_content:
                return new_content + trailing
        elif new_sentences and last_sentences:
            if new_sentences[-1].strip() != last_sentences[-1].strip():
                return new_sentences[-1].strip() + trailing
    return None


def _split_sentences(text: str) -> list[str]:
    out, cur = [], []
    for ch in text:
        if ch in _SENTENCE_ENDS:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def pcm_i16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """s16 samples -> f32 with the reference's 1/32767 scaling
    (handlers/asr.rs:188-194). The device-side dequant in the slot pool's
    admission program (runtime/slots.py) applies the SAME constant — keep
    them in lockstep."""
    return pcm.astype(np.float32) / 32767.0


def pcm16le_to_f32(data: bytes) -> np.ndarray:
    """s16 bytes -> f32 (odd trailing byte dropped)."""
    n = len(data) // 2 * 2
    return pcm_i16_to_f32(np.frombuffer(data[:n], "<i2"))


class _InlineChunk:
    """Order-preserving handle for the sequential (non-pooled) decode path:
    the decode runs at settle() time, i.e. strictly after every earlier
    chunk's settle on the single settling thread."""

    __slots__ = ("engine", "state", "audio", "params")

    def __init__(self, engine, state, audio, params):
        self.engine = engine
        self.state = state
        self.audio = audio
        self.params = params

    def settle(self):
        return self.engine.transcribe_with_state(self.state, self.audio,
                                                 self.params)


@dataclass
class StreamEvent:
    """One outbound response: newly recognized text + adjusted segments."""

    text: str
    end: int
    device_id: str
    segments: list[tuple[int, int, str]] = field(default_factory=list)  # (ms, ms, text)


class StreamSession:
    """Per-connection state machine: feed() base64 chunks, get StreamEvents.

    The transport calls feed() for each inbound message and forwards the
    returned events; finish() flushes the remainder (reference end==1 path,
    handlers/asr.rs:247-263).
    """

    def __init__(self, engine: AsrEngine, device_id: str = "",
                 language: str = "zh", denoise: bool = True,
                 chunk_bytes: int = CHUNK_BYTES, overlap_bytes: int = OVERLAP_BYTES,
                 audio_format: str = "PCM", condition: bool = True):
        self.engine = engine
        self.state = engine.create_state()
        # condition=False is whisper.cpp's no_context=true mode (the
        # reference runs no_context=false, whisper.rs:65-69): chunks carry
        # no previous-text prompt even on a conditioned-capable pool
        self.params = AsrParams(language=language, stream_mode=True,
                                min_segment_length=5,
                                condition_on_previous_text=condition)
        self.device_id = device_id
        self.denoise = denoise
        if not 0 <= overlap_bytes < chunk_bytes:
            # overlap >= chunk would make ingest()'s chunk loop never shrink
            # the buffer: the same chunk resubmits forever (livelock)
            raise ValueError(
                f"overlap_bytes ({overlap_bytes}) must be in [0, chunk_bytes"
                f"={chunk_bytes})")
        self.chunk_bytes = chunk_bytes
        self.overlap_bytes = overlap_bytes
        self.audio_format = audio_format
        self._format_checked = audio_format in ("PCM", "UNKNOWN")
        self.buffer = bytearray()
        # 2 bytes/sample s16: a chunk_bytes chunk is chunk_bytes/(2*rate) s
        self.ctx = StreamContext(block_seconds=chunk_bytes / (2.0 * SAMPLE_RATE))
        # usage accounting for authenticated streams (Auth.record_usage):
        # decoder tokens sampled + audio seconds decoded, accumulated per
        # settled chunk and read once at stream end by the transport
        self.usage_tokens = 0
        self.usage_audio_seconds = 0.0

    def feed(self, audio_b64: bytes, device_id: str = "") -> list[StreamEvent]:
        """Buffer inbound bytes and transcribe every complete chunk, blocking
        until all their events are ready (the reference's inline handler
        shape). Equivalent to ingest() + settle() of each pending in order."""
        return [ev for p in self.ingest(audio_b64, device_id)
                for ev in self.settle(p)]

    def ingest(self, audio_b64: bytes, device_id: str = "") -> list:
        """Pipelining phase 1: buffer inbound bytes, extract complete chunks,
        and SUBMIT each without waiting for its decode. Returns opaque
        pending handles (chunk order) for settle(). When the engine supports
        nonblocking submission (slot pool, unconditioned chunks), a
        backlogged stream keeps several chunks decoding concurrently;
        otherwise the chunk is decoded inline here, preserving the
        sequential semantics exactly."""
        if device_id and not self.device_id:
            self.device_id = device_id
        try:
            decoded = base64.standard_b64decode(audio_b64)
        except (binascii.Error, ValueError) as e:
            log.error("failed to decode audio: %s", e)
            return []
        self.buffer.extend(decoded)
        if not self._format_checked and len(self.buffer) >= 44:
            head = bytes(self.buffer[:64])
            if self.audio_format == "WAV" and head.startswith(b"RIFF"):
                stripped = _strip_wav_header(bytes(self.buffer))
                if stripped is None:
                    # header's chunk table spans packets: keep buffering
                    # (the next ingest re-runs this check)
                    return []
                self.buffer = bytearray(stripped)
            elif _looks_encoded(self.audio_format, head):
                raise UnsupportedStreamFormat(
                    f"streaming input tagged {self.audio_format} is actually "
                    f"encoded {self.audio_format} — the streaming path takes "
                    f"16 kHz mono s16 PCM; transcode client-side or use the "
                    f"REST batch API (ffmpeg handles any container)")
            # else: bytes don't look like the tagged container — treat as
            # PCM (wire compat: the reference example client tags AAC but
            # sends PCM, asr_client.rs:176)
            self._format_checked = True
        pendings: list = []
        while len(self.buffer) >= self.chunk_bytes:
            chunk = bytes(self.buffer[: self.chunk_bytes])
            pendings.append(self._submit_chunk(chunk))
            # keep the overlap tail (reference keeps CHUNK-OVERLAP onward)
            self.buffer = self.buffer[self.chunk_bytes - self.overlap_bytes :]
        return pendings

    def _prep_audio(self, pcm: np.ndarray):
        """Shared denoise/params dispatch for chunk and tail-flush
        submission. device_denoise engines take the raw s16 PCM plus
        AsrParams.denoise=True (the DSP chain runs on device inside the
        slot-admission program — host denoise measured ~1/3 of serving
        throughput at 64 streams, PERF.md); otherwise the host numpy chain
        runs here. Returns (submit_audio, params, host_f32) where host_f32
        is the host-denoised f32 audio (None when the wire stays s16)."""
        params = self.params
        host_f32: np.ndarray | None = None
        if self.denoise:
            if getattr(self.engine, "device_denoise", False):
                import dataclasses

                params = dataclasses.replace(self.params, denoise=True)
            else:
                from speaksense_tpu_torch.audio.dsp import DenoiseConfig, denoise_audio

                host_f32 = denoise_audio(pcm_i16_to_f32(pcm),
                                         DenoiseConfig(post_gain=1.0))
        return (pcm if host_f32 is None else host_f32), params, host_f32

    def _submit_chunk(self, chunk: bytes):
        """Submit one chunk's decode; returns a pending handle for settle().
        Falls back to a blocking inline decode when the engine has no
        nonblocking path (then the \"pending\" is just the result)."""
        # WIRE-DTYPE submission: keep the PCM as s16 until it reaches the
        # engine — the slot pool uploads it as-is (HALF the host->device
        # relay bytes of f32) and the admission program dequantizes on
        # device. f32 conversion happens lazily, only on paths that need
        # host-side DSP or the sequential engine call.
        n = len(chunk) // 2 * 2
        pcm = np.frombuffer(chunk[:n], "<i2")
        submit_audio, params, audio = self._prep_audio(pcm)
        submit = getattr(self.engine, "submit_stream_chunk", None)
        if submit is not None:
            try:
                pending = submit(self.state, submit_audio, params)
            except Exception as e:
                log.error("ASR submission failed: %s", e)
                return None
            if pending is not None:
                return pending
        # sequential path: DEFER the decode to settle() time. Settle calls
        # happen in ingest order on one thread, so a fallback chunk (off-
        # bucket, conditioning, no pool) never decodes concurrently with —
        # or ahead of — an earlier pipelined chunk's settle, which mutates
        # state.context/language (a decode inside ingest would race exactly
        # that way when pipelined and inline chunks mix). feed() ==
        # ingest()+settle() still decodes immediately.
        if audio is None:
            audio = pcm_i16_to_f32(pcm)
        return _InlineChunk(self.engine, self.state, audio, params)

    def settle(self, pending) -> list[StreamEvent]:
        """Pipelining phase 2: wait for one submitted chunk (MUST be called
        in ingest() order) and run the diff/stitching postprocess."""
        if pending is None:
            result = None
        elif hasattr(pending, "settle"):
            try:
                result = pending.settle()
            except Exception as e:
                log.error("ASR processing failed: %s", e)
                result = None
        else:
            result = pending  # inline-decoded TranscribeResult
        events: list[StreamEvent] = []
        if result is not None:
            self.usage_tokens += result.n_tokens
            # meter the stream audio CONSUMED per chunk (the buffer advances
            # chunk_bytes - overlap_bytes); billing the full chunk would
            # count the overlap region twice (~10% at 5 s/0.5 s). The tail
            # flush bills the whole remaining buffer — which still holds the
            # final overlap — so a stream's total equals the audio it sent.
            self.usage_audio_seconds += (
                (self.chunk_bytes - self.overlap_bytes) / (2.0 * SAMPLE_RATE))
            for segment in result.segments:
                new_text = process_text(segment.text, self.ctx.last_text, [segment])
                if new_text is None:
                    continue
                self.ctx.last_text = segment.text
                start_ms, end_ms = self.ctx.calculate_segment_time(
                    segment.start, segment.end)
                events.append(StreamEvent(
                    text=new_text, end=0, device_id=self.device_id,
                    segments=[(start_ms, end_ms, segment.text)]))
        self.ctx.next_block()
        return events

    def finish(self) -> list[StreamEvent]:
        """Flush remaining audio with a fresh state and emit the end:1 event.

        The tail flush PREFERS the slot pool (submit_stream_chunk with
        pad_to_bucket: the sub-chunk tail rides an admission row zero-padded
        to the pool bucket) — when many streams end together (and during the
        pool's drain) the flushes continuous-batch with live chunks instead
        of each paying a separate window-batcher dispatch. state=None keeps
        the reference's fresh-state flush semantics (no conditioning).
        Engines without a pool (or pre-kwarg fakes) take the original
        sequential transcribe path."""
        events: list[StreamEvent] = []
        if self.buffer:
            tail = bytes(self.buffer)
            self.buffer = bytearray()
            n = len(tail) // 2 * 2
            pcm = np.frombuffer(tail[:n], "<i2")
            audio = pcm_i16_to_f32(pcm)
            pending = None
            submit = getattr(self.engine, "submit_stream_chunk", None)
            if submit is not None and pcm.size:
                flush_audio, params, _ = self._prep_audio(pcm)
                try:
                    pending = submit(None, flush_audio, params,
                                     pad_to_bucket=True)
                except TypeError:  # engine predates the pad_to_bucket kwarg
                    pending = None
                except Exception as e:
                    log.error("pooled final flush submit failed: %s", e)
                    pending = None
            try:
                # sequential fallback: raw audio + base params — the
                # reference's final flush transcribes the buffer WITHOUT
                # denoise (handlers/asr.rs:235-247), unlike regular chunks
                result = (pending.settle() if pending is not None
                          else self.engine.transcribe(audio, self.params))
            except Exception as e:
                log.error("final ASR flush failed: %s", e)
                return events
            self.usage_tokens += result.n_tokens
            self.usage_audio_seconds += audio.size / SAMPLE_RATE
            final_text = process_text(result.full_text, self.ctx.last_text, result.segments)
            if final_text is not None:
                adjusted = [
                    (*self.ctx.calculate_segment_time(s.start, s.end), s.text)
                    for s in result.segments
                ]
                segments = [(a, b, t) for a, b, t in adjusted]
                events.append(StreamEvent(
                    text=final_text, end=1, device_id=self.device_id, segments=segments))
        if not events:
            events.append(StreamEvent(text="", end=1, device_id=self.device_id))
        return events
