"""Large-v3 parity fixture (`tests/golden/large_v3_f32.json`): the JAX
package at f32 on the CPU, on the large-v3-width checkpoint that the chip
smoke's ckpt phase writes for its CLI run (`tools.golden.write_seeded`,
seed 0, cut to 4 encoder and 4 decoder layers, f16 ggml), loaded through
the JAX package's ggml loader, and a seeded 30 s mel: the encoder states'
norm and four rows, the first step's top-20 logits and 24 argmax tokens.
The smoke's ckpt phase holds the port on the card against it (f32, TF32
off); this test regenerates it with JAX and holds the committed file and
the port on the CPU against it. Depth is cut to 4 + 4: regenerating it
took 14.7 s and 3.2 GiB of peak RSS at 4 + 4 layers and 22.8 s and 5.3 GiB
at 8 + 8, so the full 32 + 32 would take about 18 GiB (extrapolated), more
than a CPU test run should hold."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.ckpt import ggml as JG
from speaksense_tpu.models import whisper as JW
from speaksense_tpu_torch.ckpt import ggml as TG
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.tools import golden as G

FIXTURE = Path(__file__).parent / "golden" / "large_v3_f32.json"
SEED, MEL_SEED, N_TOKENS, LAYERS = 0, 11, 24, 4


def write_checkpoint(path) -> TW.WhisperDims:
    """The ckpt phase's LAYERS-layer large-v3-width file."""
    dims = dataclasses.replace(TW.MODEL_DIMS["large-v3"], n_audio_layer=LAYERS,
                               n_text_layer=LAYERS)
    G.write_seeded(path, dims, SEED, TG.F16)
    return dims


def jax_readings(path) -> dict:
    """The fixture's readings from the JAX package at f32 (its plain
    encoder attention on the CPU), the same argmax decode as
    `tools.golden.readings`."""
    m = JG.load_ggml(str(path))
    dims = m.dims
    params = jax.tree.map(jnp.asarray, JG.params_from_ggml(m))
    del m
    mel = jnp.asarray(G.seeded_mel(dims.n_mels, MEL_SEED))
    prompt = jnp.asarray([Tokenizer.synthetic(dims.n_vocab).sot_sequence("en")], jnp.int32)
    enc = jax.jit(lambda p, x: JW.encode(p, dims, x))(params, mel)
    P = prompt.shape[1]
    cache = JW.init_cache(dims, 1, enc.shape[1], dtype=jnp.float32, t_text=P + N_TOKENS)
    ck, cv = JW.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    logits, cache = JW.decode_prefill(params, dims, prompt, cache)
    first = logits[0, -1]
    step = jax.jit(lambda p, t, c: JW.decode_step(p, dims, t, c))
    toks = [jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)]
    for _ in range(N_TOKENS - 1):
        out, cache = step(params, toks[-1], cache)
        toks.append(jnp.argmax(out, axis=-1).astype(jnp.int32))
    order = np.argsort(-np.asarray(first), kind="stable")[:20]
    enc = np.asarray(enc)
    return {"enc_norm": float(np.linalg.norm(enc)),
            "enc_rows": enc[0, [0, 500, 1000, 1499], :8].tolist(),
            "top20_ids": order.tolist(), "top20_logits": np.asarray(first)[order].tolist(),
            "tokens": [int(t[0]) for t in toks]}


def fixture(path) -> dict:
    dims = write_checkpoint(path)
    return {"source": "JAX package, f32, CPU; tests/test_torch_golden.py",
            "checkpoint": {"dims": dataclasses.asdict(dims), "seed": SEED, "ftype": "f16",
                           "tensors": "speaksense_tpu_torch.tools.golden.seeded_ggml_tensors"},
            "mel_seed": MEL_SEED, "prompt": Tokenizer.synthetic(dims.n_vocab).sot_sequence("en"),
            "n_tokens": N_TOKENS, **jax_readings(path)}


@pytest.mark.slow
def test_large_v3_golden_fixture(tmp_path):
    """JAX gives the committed fixture again (tokens and ids equal, values
    to 1e-5), and the port on the CPU at f32 holds the bounds the card is
    held to (encoder 1e-3 and logits 1e-3 relative L2, tokens equal)."""
    want = json.loads(FIXTURE.read_text())
    got = fixture(tmp_path / "large_v3_4l.bin")
    assert got["tokens"] == want["tokens"] and got["top20_ids"] == want["top20_ids"]
    for key in ("enc_rows", "top20_logits"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)
    assert got["enc_norm"] == pytest.approx(want["enc_norm"], rel=1e-5)
    model = TW.params_from_jax(JG.params_from_ggml(JG.load_ggml(str(tmp_path / "large_v3_4l.bin"))),
                               TW.WhisperDims(**want["checkpoint"]["dims"]), device="cpu",
                               dtype=torch.float32)
    port = G.readings(model, torch.from_numpy(G.seeded_mel(128, want["mel_seed"])),
                      torch.tensor([want["prompt"]]), want["n_tokens"], want["top20_ids"])
    errs = G.errors(port, want)
    assert errs["enc_rows"] <= G.ENC_RTOL and errs["enc_norm"] <= G.ENC_RTOL
    assert errs["logits"] <= G.LOGITS_RTOL and errs["tokens_equal"], errs
