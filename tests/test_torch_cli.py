"""The port's CLI (`python -m speaksense_tpu_torch.cli`) against the JAX
package's on one tiny ggml checkpoint and one WAV file, in process on the
CPU: the same transcript JSON, the same detected language, the same
`inspect-ggml` listing."""

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


def test_not_ported_options_refuse(files):
    """--word-timestamps names its ROADMAP item; a missing checkpoint
    raises instead of falling back to random weights."""
    ckpt, wav = files
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TCLI.main(["transcribe", wav, "--model", ckpt, "--word-timestamps", "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        TCLI.main(["transcribe", wav, "--model", "missing.bin", "--device", "cpu"])
