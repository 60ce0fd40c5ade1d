"""The port's checkpoint loading against the JAX package's, on the same
seeded data on the CPU: the ggml block codecs, the container both ways, the
parameter mapping, the convert-once cache both ways, HF directories, and a
tiny ggml checkpoint transcribed by both engines (f32, greedy: exactly the
same tokens, text and segments)."""

import dataclasses
import io
import json
import logging
import os
import struct

import numpy as np
import pytest
import torch

from speaksense_tpu.asr import AsrParams as JParams
from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.ckpt import cache as JCK
from speaksense_tpu.ckpt import ggml as JG
from speaksense_tpu.ckpt import hf_dir as JHF
from speaksense_tpu.config import EngineConfig as JConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu_torch.asr import AsrParams
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.audio import mel as TMEL
from speaksense_tpu_torch.ckpt import cache as TCK
from speaksense_tpu_torch.ckpt import ggml as TG
from speaksense_tpu_torch.ckpt import hf_dir as THF
from speaksense_tpu_torch.config import Config, EngineConfig
from speaksense_tpu_torch.main import build_engine
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


# every tensor below 65,536 elements, so the JAX loader takes its numpy
# codecs too (it tries a C++ dequant from that size on)
SMALL = JW.WhisperDims(n_mels=80, n_vocab=128, n_audio_ctx=1000, n_audio_state=64,
                       n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                       n_text_head=4, n_text_layer=2)
# multilingual vocab: the special-token layout the engines decode with
DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TYPES = [TG.F32, TG.F16, TG.Q4_0, TG.Q4_1, TG.Q5_0, TG.Q5_1, TG.Q8_0]
# greedy only: t > 0 sampling draws from different RNGs in the two packages
NO_FALLBACK = dict(compute_dtype="float32", max_decode_len=64, best_of=1,
                   logprob_thold=-1e9, entropy_thold=-1.0, compression_ratio_thold=1e9)


def _tdims(dims):
    return TW.WhisperDims(**dataclasses.asdict(dims))


def _tensors(dims, seed: int) -> dict:
    return TG.ggml_tensors_from_params(JW.init_params_np(dims, seed=seed), _tdims(dims))


def _write(path_or_file, dims, ftype, seed=0, vocab=None):
    """A ggml checkpoint of `dims` from seeded weights, written by the port."""
    vocab = vocab if vocab is not None else [b" w%d" % i for i in range(min(dims.n_vocab, 50257))]
    TG.write_ggml(TG.GgmlModel(dims=_tdims(dims), ftype=ftype,
                               filters=TMEL.mel_filter_bank(dims.n_mels), vocab=vocab,
                               tensors=_tensors(dims, seed)),
                  str(path_or_file) if not hasattr(path_or_file, "write") else path_or_file,
                  ftype=ftype)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("ttype", TYPES, ids=[TG._TYPE_NAMES[t] for t in TYPES])
def test_block_codecs_match_jax(ttype):
    x = np.random.default_rng(ttype).standard_normal(32 * 97).astype(np.float32)
    x[:32] = 0.0                         # an all-zero block: the d == 0 branch
    blob = TG.quantize(x, ttype)
    assert blob == JG.quantize(x, ttype)
    assert len(blob) == TG._quant_nbytes(ttype, x.size)
    got = TG.dequantize(blob, ttype, x.size)
    want = JG.dequantize(blob, ttype, x.size, use_native=False)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ftype", TYPES, ids=[TG._TYPE_NAMES[t] for t in TYPES])
def test_containers_cross_read(ftype):
    """The JAX loader reads what the port wrote and the port reads what the
    JAX writer wrote: dims, ftype, vocab (padded past the file's 100
    entries), filters and every tensor equal."""
    vocab = [b"t%d" % i for i in range(100)]
    tensors = _tensors(SMALL, seed=ftype)
    filters = TMEL.mel_filter_bank(80)
    ours, theirs = io.BytesIO(), io.BytesIO()
    TG.write_ggml(TG.GgmlModel(dims=_tdims(SMALL), ftype=ftype, filters=filters, vocab=vocab,
                               tensors=tensors), ours, ftype=ftype)
    JG.write_ggml(JG.GgmlModel(dims=SMALL, ftype=ftype, filters=filters, vocab=vocab,
                               tensors=tensors), theirs, ftype=ftype)
    assert ours.getvalue() == theirs.getvalue()
    ours.seek(0)
    theirs.seek(0)
    j, t = JG.load_ggml(ours), TG.load_ggml(theirs)
    assert dataclasses.asdict(t.dims) == dataclasses.asdict(j.dims) == dataclasses.asdict(SMALL)
    assert t.ftype == j.ftype == ftype
    assert t.vocab == j.vocab and len(t.vocab) == SMALL.n_vocab
    assert t.vocab[127] == b"[_extra_token_127]"
    np.testing.assert_array_equal(t.filters, j.filters)
    assert list(t.tensors) == list(j.tensors)
    for name in t.tensors:
        np.testing.assert_array_equal(t.tensors[name], j.tensors[name], err_msg=name)


def test_params_mapping_matches_jax():
    """params_from_ggml gives the JAX pytree exactly, and the writer-side
    inverse gives the JAX named tensors exactly."""
    buf = io.BytesIO()
    _write(buf, SMALL, TG.Q5_1, seed=4)
    buf.seek(0)
    model = TG.load_ggml(buf)
    buf.seek(0)
    _assert_trees_equal(TG.params_from_ggml(model), JG.params_from_ggml(JG.load_ggml(buf)))
    params = JW.init_params_np(SMALL, seed=5)
    ours = TG.ggml_tensors_from_params(params, _tdims(SMALL))
    theirs = JG.ggml_tensors_from_params(params, SMALL)
    assert list(ours) == list(theirs)
    for name in ours:
        np.testing.assert_array_equal(ours[name], np.asarray(theirs[name]), err_msg=name)


def test_load_ggml_max_layers_cuts_the_depth():
    buf = io.BytesIO()
    _write(buf, SMALL, TG.F16, seed=6)
    buf.seek(0)
    full = TG.load_ggml(buf)
    buf.seek(0)
    cut = TG.load_ggml(buf, max_layers=1)
    assert (cut.dims.n_audio_layer, cut.dims.n_text_layer) == (1, 1)
    assert set(cut.tensors) == {n for n in full.tensors if ".blocks.1." not in n}
    for name, arr in cut.tensors.items():
        np.testing.assert_array_equal(arr, full.tensors[name])
    params = TG.params_from_ggml(cut)
    assert params["decoder"]["blocks"]["fc1"]["w"].shape[0] == 1


def test_weight_cache_cross_read(tmp_path, caplog):
    """The port's cache is the JAX package's format: each reads what the
    other wrote; a changed source invalidates it; an unreadable one is
    converted again with a warning."""
    src = tmp_path / "model.bin"
    _write(src, SMALL, TG.F16, seed=7)
    model = TG.load_ggml(str(src))
    params = TG.params_from_ggml(model)
    dims = dataclasses.asdict(model.dims)
    TCK.save_cached(src, tmp_path / "ours", params, dims, model.vocab, model.filters,
                    ftype=model.ftype)
    JCK.save_cached(src, tmp_path / "theirs", params, dims, model.vocab, model.filters,
                    ftype=model.ftype)
    for name in ("model.cache.json", "model.cache.npz"):
        assert (tmp_path / "ours" / name).is_file() and (tmp_path / "theirs" / name).is_file()
    for load, where in ((JCK.load_cached, "ours"), (TCK.load_cached, "theirs")):
        got_params, meta = load(src, tmp_path / where)
        _assert_trees_equal(got_params, params)
        assert meta["dims"] == dims and meta["vocab"] == model.vocab
        assert meta["ftype"] == TG.F16
        np.testing.assert_array_equal(meta["filters"], model.filters)
    st = src.stat()
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 2_000_000_000))
    assert TCK.load_cached(src, tmp_path / "ours") is None
    assert JCK.load_cached(src, tmp_path / "ours") is None
    # an unreadable entry (matching signature, broken npz): re-convert
    TCK.save_cached(src, tmp_path / "ours", params, dims, model.vocab, model.filters)
    (tmp_path / "ours" / "model.cache.npz").write_bytes(b"not an npz")
    with caplog.at_level(logging.WARNING, logger="speaksense_tpu_torch.ckpt.cache"):
        assert TCK.load_cached(src, tmp_path / "ours") is None
    assert "re-converting" in caplog.text


def _write_safetensors(path, tensors, dtype):
    """The safetensors container, with F32, F16 or BF16 data."""
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, np.float32)
        if dtype == "F16":
            raw = arr.astype("<f2").tobytes()
        elif dtype == "BF16":
            raw = (arr.view("<u4") >> 16).astype("<u2").tobytes()
        else:
            raw = arr.astype("<f4").tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


HF_TINY = dict(vocab_size=51865, num_mel_bins=80, d_model=64, encoder_layers=2,
               encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
               encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=1500,
               max_target_positions=448)


@pytest.fixture(scope="module")
def hf_state_dict():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.WhisperModel(transformers.WhisperConfig(**HF_TINY)).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    # a tied output projection, as HF checkpoints ship it: dropped on load
    sd["proj_out.weight"] = sd["decoder.embed_tokens.weight"]
    return sd


def _hf_dir(path, sd, layout):
    path.mkdir()
    (path / "config.json").write_text(json.dumps(HF_TINY))
    if layout == "sharded":
        names = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
                  "model-00002-of-00002.safetensors": names[len(names) // 2:]}
        for shard, keys in shards.items():
            _write_safetensors(path / shard, {k: sd[k] for k in keys}, "F32")
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: shard for shard, keys in shards.items() for k in keys}}))
    else:
        _write_safetensors(path / "model.safetensors", sd, layout)
    return path


@pytest.mark.parametrize("layout", ["F32", "F16", "BF16", "sharded"])
def test_load_hf_dir_matches_jax(tmp_path, hf_state_dict, layout):
    path = _hf_dir(tmp_path / "hf", hf_state_dict, layout)
    t_params, t_dims = THF.load_hf_dir(path)
    j_params, j_dims = JHF.load_hf_dir(path)
    assert dataclasses.asdict(t_dims) == dataclasses.asdict(j_dims)
    assert t_dims.n_audio_layer == 2 and t_dims.n_vocab == 51865
    _assert_trees_equal(t_params, j_params)


def test_from_hf_dir_engine_matches_jax(tmp_path, hf_state_dict):
    """Both engines on one HF directory with a speaksense_vocab.json: the
    same vocab and the same greedy tokens for one window."""
    path = _hf_dir(tmp_path / "hf", hf_state_dict, "F32")
    vocab = [b" v%d" % i for i in range(51865)]
    (path / "speaksense_vocab.json").write_text(json.dumps([v.hex() for v in vocab]))
    jeng = JEngine.from_hf_dir(str(path), config=JConfig(**NO_FALLBACK))
    teng = TEngine.from_pretrained(str(path), config=EngineConfig(**NO_FALLBACK), device="cpu")
    assert teng.tokenizer.vocab == jeng.tokenizer.vocab == vocab
    mel = np.asarray(jeng.compute_mel(_speech(6.0)))
    want, got = jeng.decode_windows(mel, "en")[0], teng.decode_windows(mel, "en")[0]
    assert got["n_sampled"] == want["n_sampled"] > 0
    np.testing.assert_array_equal(got["tokens"][:got["n_sampled"]],
                                  np.asarray(want["tokens"])[:want["n_sampled"]])


def _speech(seconds: float, seed: int = 40) -> np.ndarray:
    """Seeded pseudo-speech: voiced harmonics under a syllable-rate envelope
    plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2
    return (0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("ftype", [TG.F16, TG.Q8_0], ids=["f16", "q8_0"])
def test_tiny_ggml_transcribes_like_jax(tmp_path, ftype):
    """One tiny checkpoint, loaded by the JAX engine (no cache) and by the
    port's from_pretrained through its weight cache, f32 on the CPU: the
    same filters and vocab, and exactly the same greedy tokens, text and
    segments from transcribe (a 40 s input: two windows of the seek
    loop), with and without a language."""
    path = tmp_path / "tiny.bin"
    _write(path, DIMS, ftype, seed=2)
    jeng = JEngine.from_ggml(str(path), config=JConfig(**NO_FALLBACK), use_cache=False)
    cfg = EngineConfig(**NO_FALLBACK, weight_cache_dir=str(tmp_path / "cache"))
    teng = TEngine.from_pretrained(str(path), config=cfg, device="cpu")
    assert (tmp_path / "cache" / "tiny.cache.npz").is_file()
    assert teng.name == str(path) and teng.model.dtype == torch.float32
    np.testing.assert_array_equal(teng.mel_filters, jeng.mel_filters)
    assert teng.tokenizer.vocab == jeng.tokenizer.vocab
    audio = _speech(40.0)
    mel = np.asarray(jeng.compute_mel(audio[:16000 * 30]))
    want, got = jeng.decode_windows(mel, "en")[0], teng.decode_windows(mel, "en")[0]
    assert got["n_sampled"] == want["n_sampled"] > 0
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    for language in ("en", None):
        w = jeng.transcribe(audio, JParams(language=language))
        g = teng.transcribe(audio, AsrParams(language=language))
        assert g.n_tokens == w.n_tokens > 0 and g.language == w.language
        assert g.full_text == w.full_text
        assert [s.to_dict() for s in g.segments] == [s.to_dict() for s in w.segments]
    # the warm load from the cache gives the same model
    warm = TEngine.from_pretrained(str(path), config=cfg, device="cpu")
    for a, b in zip(warm.model.state_dict().values(), teng.model.state_dict().values()):
        assert torch.equal(a, b)


def test_missing_checkpoint_raises(tmp_path):
    """No fallback to random weights: a missing file or directory raises,
    from the engine and from the composition root alike."""
    with pytest.raises(FileNotFoundError, match="nope.bin"):
        TEngine.from_pretrained(str(tmp_path / "nope.bin"), device="cpu")
    with pytest.raises(FileNotFoundError, match="nope-dir"):
        TEngine.from_hf_dir(str(tmp_path / "nope-dir"), device="cpu")
    with pytest.raises(FileNotFoundError):
        build_engine(Config(model_path=str(tmp_path / "nope.bin")), device="cpu")
    # int8 weights load like any others: a missing file still raises
    with pytest.raises(FileNotFoundError, match="nope.bin"):
        TEngine.from_pretrained(str(tmp_path / "nope.bin"),
                                config=EngineConfig(weights_int8=True), device="cpu")
