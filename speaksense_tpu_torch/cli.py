"""CLI of the port: transcribe audio files from the command line on the GPU.

The counterpart of `speaksense_tpu/cli.py` for its model subcommands
(`transcribe`, `detect-language`, `inspect-ggml`), with the same options
plus `--device` (default `cuda`; `cpu` runs the kernels' plain versions).
Usage:

  python -m speaksense_tpu_torch.cli transcribe file.wav --model models/ggml-large-v3.bin
  python -m speaksense_tpu_torch.cli detect-language file.wav --model ...
  python -m speaksense_tpu_torch.cli inspect-ggml models/ggml-large-v3.bin

`--word-timestamps` is accepted and refused with the ROADMAP item that ports
it; the host-DSP subcommands of the JAX CLI (quality, voiceprint, emotion,
denoise) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_engine(args):
    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.config import EngineConfig

    cfg = EngineConfig()
    if args.fp32:
        cfg.compute_dtype = "float32"
    if args.random_model:
        return WhisperEngine.from_random(args.random_model, config=cfg, device=args.device)
    if not args.model:
        sys.exit("--model PATH (ggml .bin or HF directory) or --random-model NAME required")
    return WhisperEngine.from_pretrained(args.model, config=cfg, device=args.device)


def cmd_transcribe(args):
    from speaksense_tpu_torch.asr import AsrParams
    from speaksense_tpu_torch.audio.io import load_audio

    engine = _load_engine(args)
    audio = load_audio(args.file)
    t0 = time.time()
    result = engine.transcribe_audio(audio, AsrParams(
        language=args.language, task=args.task,
        speaker_diarization=args.diarize,
        word_timestamps=args.word_timestamps))
    dt = time.time() - t0
    dur = len(audio) / 16000.0
    if args.json:
        print(json.dumps(result.to_dict(), ensure_ascii=False, indent=2))
    else:
        for s in result.segments:
            print(f"[{s.start:8.2f} --> {s.end:8.2f}]  {s.text}")
        print(f"\n{result.full_text}")
    print(f"\n# {dur:.1f}s audio in {dt:.2f}s — {dur / max(dt, 1e-9):.1f}x realtime "
          f"(lang={result.language}, device={args.device})", file=sys.stderr)


def cmd_detect_language(args):
    from speaksense_tpu_torch.audio.io import load_audio

    engine = _load_engine(args)
    print(engine.detect_language(load_audio(args.file)))


def cmd_inspect_ggml(args):
    from speaksense_tpu_torch.ckpt.ggml import _TYPE_NAMES, load_ggml

    model = load_ggml(args.file)
    print(f"dims: {model.dims}")
    print(f"ftype: {_TYPE_NAMES.get(model.ftype, model.ftype)}")
    print(f"mel filters: {model.filters.shape}")
    print(f"vocab: {len(model.vocab)} tokens")
    print(f"tensors: {len(model.tensors)}")
    total = sum(t.size for t in model.tensors.values())
    print(f"parameters: {total / 1e6:.1f}M")
    if args.tensors:
        for name, t in model.tensors.items():
            print(f"  {name}: {t.shape}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="speaksense-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--model", help="ggml checkpoint file or HF checkpoint directory")
        sp.add_argument("--random-model", help="random-weight model name (testing)")
        sp.add_argument("--fp32", action="store_true", help="compute in f32")
        sp.add_argument("--device", default="cuda", help="torch device (default cuda)")

    t = sub.add_parser("transcribe", help="transcribe an audio file")
    t.add_argument("file")
    t.add_argument("--language", default=None)
    t.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    t.add_argument("--diarize", action="store_true")
    t.add_argument("--word-timestamps", action="store_true",
                   help="per-word times (not ported yet: raises)")
    t.add_argument("--json", action="store_true")
    common(t)
    t.set_defaults(fn=cmd_transcribe)

    d = sub.add_parser("detect-language", help="detect spoken language")
    d.add_argument("file")
    common(d)
    d.set_defaults(fn=cmd_detect_language)

    g = sub.add_parser("inspect-ggml", help="inspect a ggml checkpoint")
    g.add_argument("file")
    g.add_argument("--tensors", action="store_true")
    g.set_defaults(fn=cmd_inspect_ggml)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
