"""The port's native C++ dequant (speaksense_tpu_torch/native) against the
port's numpy codecs and the JAX package's `dequantize`: exact equality on
the same bytes. Skips where g++ is missing, as the JAX package's tests do."""

import shutil

import numpy as np
import pytest

from speaksense_tpu.ckpt import ggml as JG
from speaksense_tpu_torch.ckpt import ggml as G
from speaksense_tpu_torch.native import dequantize_native, native_available, pcm16_to_f32_native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")

TYPES = [G.F16, G.Q4_0, G.Q4_1, G.Q5_0, G.Q5_1, G.Q8_0]


@pytest.mark.parametrize("ttype", TYPES)
def test_native_matches_numpy(ttype, rng):
    x = rng.standard_normal(32 * 4096).astype(np.float32)
    blob = G.quantize(x, ttype)
    ref = G.dequantize(blob, ttype, x.size, use_native=False)
    got = dequantize_native(blob, ttype, x.size)
    np.testing.assert_array_equal(got, ref)
    # the default route takes the native kernels at this size
    np.testing.assert_array_equal(G.dequantize(blob, ttype, x.size), ref)


def test_native_multithreaded_large(rng):
    x = rng.standard_normal(32 * 40000).astype(np.float32)  # above 1024 blocks
    blob = G.quantize(x, G.Q5_1)
    ref = G.dequantize(blob, G.Q5_1, x.size, use_native=False)
    np.testing.assert_array_equal(dequantize_native(blob, G.Q5_1, x.size, nthreads=8), ref)


def test_pcm16_native(rng):
    pcm = rng.integers(-32768, 32767, 10001).astype(np.int16)
    got = pcm16_to_f32_native(pcm.tobytes())
    np.testing.assert_array_equal(got, pcm.astype(np.float32) / np.float32(32768.0))


@pytest.mark.parametrize("ttype", TYPES)
def test_native_matches_jax_dequantize(ttype, rng):
    """The same bytes through the JAX package's `dequantize` (numpy codec)
    and the port's native route."""
    x = rng.standard_normal(32 * 2048 + 32 * 7).astype(np.float32)
    blob = JG.quantize(x, ttype)
    assert blob == G.quantize(x, ttype)
    ref = JG.dequantize(blob, ttype, x.size, use_native=False)
    np.testing.assert_array_equal(G.dequantize(blob, ttype, x.size), ref)


def test_native_refuses_bad_input():
    assert native_available()
    with pytest.raises(ValueError, match="unsupported"):
        dequantize_native(b"\0" * 64, 5, 32)
    with pytest.raises(ValueError, match="fewer"):
        dequantize_native(b"\0" * 17, G.Q4_0, 32)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["address", "thread"])
def test_native_kernels_sanitizer_clean(kind):
    """ASAN+UBSAN and TSAN runs of the port's copy of the kernels, the
    threaded block paths included."""
    from speaksense_tpu_torch.native.build import build_sanitizer

    out = build_sanitizer(kind)
    assert out is not None
    out.unlink(missing_ok=True)
