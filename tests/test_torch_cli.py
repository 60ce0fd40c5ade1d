"""The port's CLI (`python -m speaksense_tpu_torch.cli`) against the JAX
package's on one tiny ggml checkpoint and one WAV file, in process on the
CPU: the same transcript JSON (with and without word timestamps), the same
detected language, the same `inspect-ggml` listing, and the same output of
the host-DSP subcommands (`quality`, `voiceprint`, `emotion`, `denoise`)."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from speaksense_tpu import cli as JCLI
from speaksense_tpu import config as JC
from speaksense_tpu.models import whisper as JW
from speaksense_tpu_torch import cli as TCLI
from speaksense_tpu_torch import config as TC
from speaksense_tpu_torch.audio import mel as TMEL
from speaksense_tpu_torch.audio.io import write_wav
from speaksense_tpu_torch.ckpt import ggml as TG
from speaksense_tpu_torch.models import whisper as TW


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them, slowing these small ops tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
# greedy only (t > 0 sampling draws from different RNGs in the two
# packages) and a short token budget; the CLI reads the defaults
GREEDY = dict(max_decode_len=64, logprob_thold=-1e9, entropy_thold=-1.0,
              compression_ratio_thold=1e9)


@pytest.fixture()
def files(tmp_path, monkeypatch):
    """A tiny f16 checkpoint and 12 s of seeded pseudo-speech, in a working
    directory where both CLIs keep their default weight cache."""
    tdims = TW.WhisperDims(**dataclasses.asdict(DIMS))
    tensors = TG.ggml_tensors_from_params(JW.init_params_np(DIMS, seed=2), tdims)
    ckpt = tmp_path / "tiny.bin"
    TG.write_ggml(TG.GgmlModel(dims=tdims, ftype=TG.F16, filters=TMEL.mel_filter_bank(80),
                               vocab=[b" w%d" % i for i in range(50257)], tensors=tensors),
                  str(ckpt), ftype=TG.F16)
    rng = np.random.default_rng(12)
    t = np.arange(16000 * 12) / 16000
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000) / k for k in range(1, 6))
    wav = tmp_path / "speech.wav"
    write_wav(wav, 0.2 * voiced * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2)
              + 0.02 * rng.standard_normal(t.size))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(JC, "EngineConfig", functools.partial(JC.EngineConfig, **GREEDY))
    monkeypatch.setattr(TC, "EngineConfig", functools.partial(TC.EngineConfig, **GREEDY))
    return str(ckpt), str(wav)


def test_transcribe_json_matches_jax_cli(files, capsys):
    """f32 compute on both sides; the JAX CLI runs first and writes the
    weight cache, which the port's CLI then reads."""
    ckpt, wav = files
    out = []
    for main, extra in ((JCLI.main, []), (TCLI.main, ["--device", "cpu"])):
        main(["transcribe", wav, "--model", ckpt, "--json", "--fp32", *extra])
        out.append(json.loads(capsys.readouterr().out))
    want, got = out
    assert got["segments"] and got["full_text"]
    assert got == want
    assert (json.loads(capsys.readouterr().out or "{}") == {})


def test_detect_language_matches_jax_cli(files, capsys):
    ckpt, wav = files
    JCLI.main(["detect-language", wav, "--model", ckpt, "--fp32"])
    want = capsys.readouterr().out
    TCLI.main(["detect-language", wav, "--model", ckpt, "--fp32", "--device", "cpu"])
    assert capsys.readouterr().out == want and want.strip()


def test_inspect_ggml_lists_the_same_tensors(files, capsys):
    ckpt, _ = files
    JCLI.main(["inspect-ggml", ckpt, "--tensors"])
    want = capsys.readouterr().out
    TCLI.main(["inspect-ggml", ckpt, "--tensors"])
    got = capsys.readouterr().out
    assert got == want
    assert "encoder.blocks.1.attn.query.weight: (64, 64)" in got


def test_not_ported_options_refuse(files, capsys):
    """--word-timestamps, once refused, now gives the JAX CLI's JSON with
    each segment's words (f32 compute on both sides); a missing checkpoint
    still raises instead of falling back to random weights."""
    ckpt, wav = files
    out = []
    for main, extra in ((JCLI.main, []), (TCLI.main, ["--device", "cpu"])):
        main(["transcribe", wav, "--model", ckpt, "--json", "--fp32", "--word-timestamps",
              *extra])
        out.append(json.loads(capsys.readouterr().out))
    want, got = out
    assert got == want
    assert got["segments"] and all("words" in s for s in got["segments"])
    assert any(s["words"] for s in got["segments"])
    # the text listing: a line per word under its segment, as the JAX CLI
    # prints it
    TCLI.main(["transcribe", wav, "--model", ckpt, "--fp32", "--word-timestamps",
               "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    want_lines = []
    for seg in want["segments"]:
        want_lines.append(f"[{seg['start']:8.2f} --> {seg['end']:8.2f}]  {seg['text']}")
        want_lines += [f"    [{w['start']:7.2f} --> {w['end']:7.2f}] {w['word']}"
                       for w in seg["words"]]
    assert lines[:len(want_lines)] == want_lines
    with pytest.raises(FileNotFoundError):
        TCLI.main(["transcribe", wav, "--model", "missing.bin", "--device", "cpu"])


@pytest.mark.parametrize("argv", [["quality"], ["voiceprint"], ["emotion"],
                                  ["voiceprint", "--compare-with", "other"],
                                  ["voiceprint", "--compare-with", "other", "--threshold", "0.99"],
                                  ["denoise", "--output", "clean.wav"]],
                         ids=["quality", "voiceprint", "emotion", "compare", "threshold",
                              "denoise"])
def test_host_dsp_subcommands_match_jax_cli(files, tmp_path, capsys, argv):
    """Each host-DSP subcommand prints what the JAX CLI prints on the same
    WAV (denoise: the same output file, byte for byte)."""
    _, wav = files
    other = tmp_path / "other.wav"
    rng = np.random.default_rng(3)
    t = np.arange(16000 * 3) / 16000
    write_wav(other, 0.3 * np.sin(2 * np.pi * 230 * t) + 0.01 * rng.standard_normal(t.size))
    argv = [str(other) if a == "other" else a for a in argv]
    out = []
    for i, main in enumerate((JCLI.main, TCLI.main)):
        args = [argv[0], wav, *argv[1:]]
        if argv[0] == "denoise":
            args[-1] = str(tmp_path / f"clean{i}.wav")
        main(args)
        out.append(capsys.readouterr().out)
    want, got = out
    if argv[0] == "denoise":
        assert got.strip() == str(tmp_path / "clean1.wav")
        assert ((tmp_path / "clean1.wav").read_bytes() == (tmp_path / "clean0.wav").read_bytes())
    else:
        assert got == want
        json.loads(got)
    if "--compare-with" in argv:
        res = json.loads(got)
        assert res["threshold"] == (0.99 if "--threshold" in argv else 0.75)
        assert res["match"] is (res["similarity"] >= res["threshold"])
