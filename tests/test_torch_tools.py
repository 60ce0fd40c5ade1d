"""The port's measurement tools on the CPU at tiny dims: the decode
microbench (its `full` variant is `W.decode_step`, and its ablation builder
with nothing removed reproduces it), the slot microbench's rows, the probe's
byte count (exact, from the pool's shapes), and the WER harness against the
repository's `tools/wer_check.py` (the same normalisation, distances,
corpus WER and promotion rule on `tests/test_wer.py`'s strings; the same
hypotheses as the JAX engine on a two-file manifest; the command line on
a ggml file)."""

import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

from speaksense_tpu.asr import AsrParams as JAsrParams
from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig as JEngineConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.audio import mel as TMEL
from speaksense_tpu_torch.ckpt import ggml as TG
from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.slots import SlotPool
from speaksense_tpu_torch.tools import microbench_decode as MD
from speaksense_tpu_torch.tools import microbench_slots as MS
from speaksense_tpu_torch.tools import probe_slots as MP
from speaksense_tpu_torch.tools import wer_check as TWER

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import wer_check as JWER  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test run puts several workers on
    the cores, and torch's thread pool then spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
GREEDY = dict(compute_dtype="float32", max_decode_len=32, compression_ratio_thold=1e9,
              logprob_thold=-1e9, entropy_thold=-1.0)


def _model(dtype=torch.float32):
    return TW.init_random(TDIMS, torch.Generator().manual_seed(1), device="cpu", dtype=dtype)


def test_decode_variants_match_decode_step():
    """The `full` variant is 20 steps of `W.decode_step`, token for token;
    the ablation builder with nothing removed gives the same tokens, so each
    ablation differs from the production step by its removal alone."""
    model = _model()
    steps = 20
    caches = [MD.make_cache(model, 2, 64, ring=False, seed=0) for _ in range(3)]
    want = torch.zeros(2, dtype=torch.long)
    plen = torch.full((2,), MD.PREFILLED, dtype=torch.long)
    for step in range(steps):
        want = TW.decode_step(model, want, caches[0], step, plen, MD.PREFILLED).argmax(-1)
    full = MD.decode(model, caches[1], "full", steps)
    whole = MD.decode(model, caches[2], "none", steps)
    assert torch.equal(full, want) and torch.equal(whole, want)
    torch.testing.assert_close(caches[2].self_k, caches[0].self_k, rtol=0, atol=0)


def test_microbench_decode_runs_every_variant(tmp_path, capsys):
    out = tmp_path / "decode.json"
    MD.main(["--device", "cpu", "--batch", "2", "--steps", "4", "--t-self", "32",
             "--out", str(out)], dims=TDIMS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = json.loads(out.read_text())["rows"]
    assert set(rows) == set(MD.VARIANTS)
    for v in MD.VARIANTS:
        assert line[f"{v}_ms_per_step"] > 0 and rows[v]["device_busy_ms_per_step"] is None


def test_microbench_slots_rows(tmp_path, capsys):
    out = tmp_path / "slots.json"
    MS.main(["24", "512", "8", "--device", "cpu", "--out", str(out)], dims=TDIMS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = json.loads(out.read_text())["rows"]
    assert set(rows) == {"admit", "admit8", "step", "retire", "full_step"}
    assert all(r["host_ms"] > 0 and r["device_busy_ms"] is None for r in rows.values())
    assert line["step_host_ms"] == rows["step"]["host_ms"] and line["card"] == "cpu"


@pytest.mark.parametrize("self_int8", [True, False])
def test_probe_counts_the_pool_bytes(self_int8, tmp_path, capsys):
    """`step_bytes` of a tiny pool equals the bytes its shapes give: the
    decoder's weights but the cross-KV projections (bf16 matrices, f32
    norms and biases, S rows of the positional table), the pages (int8
    with f32 per-token scales and a bf16 ring of 16 rows, or bf16), the
    int8 cross-KV with f32 per-channel scales, and the pool state."""
    S, max_new, t_mel = 4, 8, 512
    engine = TEngine(_model(torch.bfloat16), Tokenizer.synthetic(TDIMS.n_vocab),
                     config=EngineConfig(cross_kv_int8=True))
    pool = SlotPool(engine, n_slots=S, t_mel=t_mel, max_new=max_new, int8_kv=True,
                    self_int8=self_int8)
    d, L, V = TDIMS.n_text_state, TDIMS.n_text_layer, TDIMS.n_vocab
    T, A, W_ = 128, t_mel // 2, 16
    # per block: qkv, o, cq, co, fc1, fc2 matrices in bf16 (k has no bias);
    # the biases and three norms in f32
    block = 2 * (3 * d * d + d * d + d * d + d * d + 4 * d * d + 4 * d * d)
    block += 4 * (3 * d + d + d + d + 4 * d + d) + 4 * 3 * 2 * d
    weights = L * block + 4 * 2 * d + 2 * V * d + S * 2 * d
    page = L * S * d * T
    pages = (2 * page + 2 * 4 * page // (d // TDIMS.n_text_head) + 2 * 2 * L * S * d * W_
             if self_int8 else 2 * 2 * page)
    cross = 2 * L * S * d * A + 2 * 4 * L * S * d
    state = S * (8 * max_new + 4 * V + 8 * 8 + 1 + 3 * 4)
    got = MP.step_bytes(pool)
    assert got == {"weights": weights, "pages": pages, "cross": cross, "state": state,
                   "total": weights + pages + cross + state}
    out = tmp_path / "probe.json"
    MP.main(["--slots", str(S), "--max-new", str(max_new), "--steps", "2", "--device", "cpu",
             "--out", str(out)] + ([] if self_int8 else ["--no-self-int8"]), dims=TDIMS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["total_bytes"] == got["total"] and line["device_busy_ms"] is None
    assert line["floor_ms"] == pytest.approx(1e3 * got["total"] / 3.35e12)


# the strings of tests/test_wer.py
TEXTS = ["Hello, World!", "  don't   STOP ", "café", "你好world", "the cat sat",
         "the bat sat down", "", "spurious output", "nine ten", "wrong words",
         "one two three four five six seven eight"]
PAIRS = [[("one two three four five six seven eight",
           "one two three four five six seven eight"), ("nine ten", "wrong words")],
         [("", "spurious output")], [("the cat sat", "the bat sat down"), ("café", "cafe")]]
RATES = [({"wer_pct": 5.0, "per_file_pct": [4.0, 6.0]}, c) for c in (
    {"wer_pct": 5.05, "per_file_pct": [4.5, 6.1]}, {"wer_pct": 5.3, "per_file_pct": [5.0, 6.0]},
    {"wer_pct": 5.02, "per_file_pct": [4.0, 7.5]})]


def test_wer_math_matches_the_reference():
    for text in TEXTS:
        assert TWER.normalize_text(text) == JWER.normalize_text(text)
    for a in TEXTS:
        for b in TEXTS:
            ref, hyp = JWER.normalize_text(a), JWER.normalize_text(b)
            assert TWER.edit_distance(ref, hyp) == JWER.edit_distance(ref, hyp)
    for pairs in PAIRS:
        assert TWER.corpus_wer(pairs) == JWER.corpus_wer(pairs)
    for base, cand in RATES:
        for kw in ({}, {"delta_pts": 0.5, "file_pts": 2.0}):
            assert TWER.check_promotion(base, cand, **kw) == JWER.check_promotion(base, cand,
                                                                                  **kw)


def _manifest(tmp_path) -> str:
    rng = np.random.default_rng(5)
    lines = []
    for i, ref in enumerate(["hello there", "general kenobi"]):
        path = tmp_path / f"f{i}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(16000 * (2 + i)) * 3000).astype(np.int16)
                          .tobytes())
        lines.append(f"{path}\t{ref}")
    (tmp_path / "manifest.tsv").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "manifest.tsv")


def test_wer_on_a_tiny_engine_matches_jax(tmp_path):
    """transcribe_all on the port's engine gives the JAX engine's
    hypotheses on the same f32 weights (greedy, the ladder off), so the two
    harnesses score the manifest alike."""
    np_params = JW.init_params_np(DIMS, seed=4)
    manifest = TWER.read_manifest(_manifest(tmp_path))
    port = TEngine.from_jax_params(np_params, TDIMS, Tokenizer.synthetic(DIMS.n_vocab),
                                   config=EngineConfig(**GREEDY), device="cpu")
    jax_engine = JEngine(np_params, DIMS, JTokenizer.synthetic(DIMS.n_vocab),
                         config=JEngineConfig(**GREEDY))
    got = TWER.transcribe_all(port, manifest, "en")
    from speaksense_tpu.audio import io as JIO

    want = [(ref, jax_engine.transcribe(JIO.load_audio(wav), JAsrParams(language="en")).full_text)
            for wav, ref in manifest]
    assert got == want and any(hyp for _, hyp in got)
    assert TWER.corpus_wer(got) == JWER.corpus_wer(want)


def test_wer_command_line_on_a_ggml_file(tmp_path, monkeypatch, capsys):
    """The command line end to end on a tiny ggml file: baseline and int8
    weights, one JSON line with the reference's keys. The engines decode
    greedily, 16 tokens a window (on random weights the default ladder
    climbs every rung at 224 tokens)."""
    monkeypatch.chdir(tmp_path)                 # the weight cache is ./asr_data
    engine = TWER._engine
    monkeypatch.setattr(TWER, "_engine", lambda path, device, **kw: engine(
        path, device, **{**GREEDY, "max_decode_len": 32, "compute_dtype": "bfloat16"}, **kw))
    path = tmp_path / "tiny.bin"
    TG.write_ggml(TG.GgmlModel(dims=TDIMS, ftype=TG.F32, filters=TMEL.mel_filter_bank(80),
                               vocab=[b" w%d" % i for i in range(50257)],
                               tensors=TG.ggml_tensors_from_params(
                                   JW.init_params_np(DIMS, seed=4), TDIMS)), str(path),
                  ftype=TG.F32)
    assert TWER.main(["--model", str(path), "--manifest", _manifest(tmp_path),
                      "--compare-int8-weights", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"baseline_wer_pct", "files", "ref_words", "int8_wer_pct",
                        "delta_pct_points", "worst_file_delta", "promote"}
    assert out["files"] == 2 and out["ref_words"] == 4
