"""WER harness: the executable promotion gate for quantized serving
configurations, on the port's engine. The counterpart of the repository's
`tools/wer_check.py`, with its normalisation, edit distance, corpus WER and
promotion rule.

    python -m speaksense_tpu_torch.tools.wer_check --model /path/ggml-large-v3.bin \\
        --manifest manifest.tsv --compare-int8-weights

manifest.tsv: one `<wav-path>\\t<reference-text>` per line (LibriSpeech
test-clean style). Every file is transcribed by `WhisperEngine`
(`from_pretrained`: a ggml file through the weight cache, or an HF
directory) after `audio/io.py`'s `load_audio`, with the baseline
configuration and, with --compare-int8-weights, with int8 decoder weights;
the tool prints corpus WER for both and the delta as one JSON line.

PROMOTION CRITERION (the reference's): turn `weights_int8` on by default
for the serving path when, on >= 1 hour of held-out speech,

    WER(int8) - WER(bf16) <= 0.1 absolute percentage points
    and no single file regresses by > 1.0 points.

The same harness gates any later quantization step. Hermetic proxies (the
drift bounds of the tests) bound numerical drift but cannot certify WER.
No real checkpoint or speech corpus is in the repository, so no WER has
been measured.

The reference's engine driver calls `WhisperEngine.from_checkpoint`, which
the JAX engine does not have; the port loads with `from_pretrained`.
Flags as the reference's, and --device (cuda; a run without a card raises).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import unicodedata


# ---------------------------------------------------------------------------
# text normalization (openai/whisper EnglishTextNormalizer-lite: for parity
# deltas between two configurations of one engine a shared normalization is
# enough)
# ---------------------------------------------------------------------------

def normalize_text(text: str) -> list[str]:
    """Lowercase, strip punctuation and diacritics, collapse whitespace;
    returns the words WER is computed over. CJK text is split per
    character (CER-style scoring for zh/ja)."""
    text = unicodedata.normalize("NFKD", text.lower())
    text = "".join(c for c in text if not unicodedata.combining(c))
    text = re.sub(r"([぀-ヿ㐀-鿿豈-﫿])", r" \1 ", text)
    text = re.sub(r"[^\w\s']", " ", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text.split()


def edit_distance(ref: list[str], hyp: list[str]) -> int:
    """Word-level Levenshtein (substitution, insertion and deletion each
    cost 1), two rows of dynamic programming."""
    if not ref:
        return len(hyp)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1,                 # deletion
                         cur[j - 1] + 1,              # insertion
                         prev[j - 1] + (r != h))      # substitution or match
        prev = cur
    return prev[-1]


def corpus_wer(pairs: list[tuple[str, str]]) -> dict:
    """pairs: (reference text, hypothesis text). Corpus WER = total edits /
    total reference words (not the mean of per-file rates), plus per-file
    rates for the no-single-file-regression clause."""
    total_edits = 0
    total_words = 0
    per_file = []
    for ref_text, hyp_text in pairs:
        ref = normalize_text(ref_text)
        hyp = normalize_text(hyp_text)
        e = edit_distance(ref, hyp)
        total_edits += e
        total_words += len(ref)
        per_file.append(100.0 * e / max(1, len(ref)))
    return {"wer_pct": 100.0 * total_edits / max(1, total_words),
            "per_file_pct": per_file,
            "ref_words": total_words}


def check_promotion(base: dict, cand: dict,
                    delta_pts: float = 0.1, file_pts: float = 1.0) -> dict:
    """The promotion rule, as data: corpus delta and worst per-file delta."""
    worst = max((c - b for b, c in zip(base["per_file_pct"],
                                       cand["per_file_pct"])), default=0.0)
    delta = cand["wer_pct"] - base["wer_pct"]
    return {"delta_pct_points": round(delta, 3),
            "worst_file_delta": round(worst, 3),
            "promote": bool(delta <= delta_pts and worst <= file_pts)}


# ---------------------------------------------------------------------------
# driving the engine
# ---------------------------------------------------------------------------

def transcribe_all(engine, manifest: list[tuple[str, str]],
                   language: str) -> list[tuple[str, str]]:
    """(reference, hypothesis) for every (wav, reference) of the manifest."""
    from speaksense_tpu_torch.asr import AsrParams
    from speaksense_tpu_torch.audio import io as AIO

    out = []
    for wav, ref in manifest:
        res = engine.transcribe(AIO.load_audio(wav), AsrParams(language=language))
        out.append((ref, res.full_text))
    return out


def _engine(model_path: str, device: str, **overrides):
    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.config import EngineConfig
    from speaksense_tpu_torch.tools.measure import resolve_device

    return WhisperEngine.from_pretrained(model_path, config=EngineConfig(**overrides),
                                         device=resolve_device(device))


def read_manifest(path: str) -> list[tuple[str, str]]:
    manifest = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                wav, ref = line.split("\t", 1)
                manifest.append((wav, ref))
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model", required=True, help="ggml file or HF directory")
    ap.add_argument("--manifest", required=True,
                    help="TSV: <wav-path>\\t<reference-text> per line")
    ap.add_argument("--language", default="en")
    ap.add_argument("--compare-int8-weights", action="store_true",
                    help="gate: bf16 baseline against the weights_int8 candidate")
    ap.add_argument("--delta-points", type=float, default=0.1,
                    help="largest corpus WER regression (absolute percentage points)")
    ap.add_argument("--file-points", type=float, default=1.0,
                    help="largest single-file WER regression (absolute percentage points)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    manifest = read_manifest(args.manifest)
    base = corpus_wer(transcribe_all(_engine(args.model, args.device), manifest,
                                     args.language))
    result = {"baseline_wer_pct": round(base["wer_pct"], 3),
              "files": len(manifest), "ref_words": base["ref_words"]}
    if args.compare_int8_weights:
        cand = corpus_wer(transcribe_all(_engine(args.model, args.device, weights_int8=True),
                                         manifest, args.language))
        result["int8_wer_pct"] = round(cand["wer_pct"], 3)
        result.update(check_promotion(base, cand, args.delta_points, args.file_points))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
