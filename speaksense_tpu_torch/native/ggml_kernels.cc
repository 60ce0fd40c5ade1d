// The port's own copy of speaksense_tpu/native/ggml_kernels.cc, with the
// original's names and behaviour: speaksense_tpu_torch/ckpt/ggml.py decodes
// tensors of 65,536 elements or more through these kernels
// (speaksense_tpu_torch/native/loader.py).
//
// Native (C++) ggml dequantization kernels.
//
// The reference's entire native surface is whisper.cpp/ggml (SURVEY.md §2);
// in this port the compute path is PyTorch on the GPU, and the remaining
// native hot spot is host-side checkpoint decode: dequantizing a ~3 GB
// quantized ggml file into f32 before upload. These kernels are the
// multithreaded C++ counterpart of ckpt/ggml.py's numpy codecs (same block
// layouts: Q4_0/Q4_1/Q5_0/Q5_1/Q8_0 + F16), exposed through a C ABI for
// ctypes (no pybind11 in this image).
//
// Build: see speaksense_tpu_torch/native/build.py (g++ -O3 -shared -fPIC
// -pthread), into a library named by the source's hash.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int QK = 32;

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3ffu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

inline uint16_t load_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

inline uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Per-block record sizes (bytes)
constexpr int REC_Q4_0 = 18, REC_Q4_1 = 20, REC_Q5_0 = 22, REC_Q5_1 = 24,
              REC_Q8_0 = 34;

void dequant_q4_0(const uint8_t* src, float* dst, int64_t nb) {
  for (int64_t b = 0; b < nb; ++b) {
    const uint8_t* rec = src + b * REC_Q4_0;
    float d = f16_to_f32(load_u16(rec));
    const uint8_t* qs = rec + 2;
    float* out = dst + b * QK;
    for (int j = 0; j < 16; ++j) {
      out[j] = ((int)(qs[j] & 0x0F) - 8) * d;
      out[j + 16] = ((int)(qs[j] >> 4) - 8) * d;
    }
  }
}

void dequant_q4_1(const uint8_t* src, float* dst, int64_t nb) {
  for (int64_t b = 0; b < nb; ++b) {
    const uint8_t* rec = src + b * REC_Q4_1;
    float d = f16_to_f32(load_u16(rec));
    float m = f16_to_f32(load_u16(rec + 2));
    const uint8_t* qs = rec + 4;
    float* out = dst + b * QK;
    for (int j = 0; j < 16; ++j) {
      out[j] = (qs[j] & 0x0F) * d + m;
      out[j + 16] = (qs[j] >> 4) * d + m;
    }
  }
}

void dequant_q5_0(const uint8_t* src, float* dst, int64_t nb) {
  for (int64_t b = 0; b < nb; ++b) {
    const uint8_t* rec = src + b * REC_Q5_0;
    float d = f16_to_f32(load_u16(rec));
    uint32_t qh = load_u32(rec + 2);
    const uint8_t* qs = rec + 6;
    float* out = dst + b * QK;
    for (int j = 0; j < 16; ++j) {
      int xh0 = ((qh >> j) << 4) & 0x10;
      int xh1 = (qh >> (j + 12)) & 0x10;
      out[j] = (((int)(qs[j] & 0x0F) | xh0) - 16) * d;
      out[j + 16] = (((int)(qs[j] >> 4) | xh1) - 16) * d;
    }
  }
}

void dequant_q5_1(const uint8_t* src, float* dst, int64_t nb) {
  for (int64_t b = 0; b < nb; ++b) {
    const uint8_t* rec = src + b * REC_Q5_1;
    float d = f16_to_f32(load_u16(rec));
    float m = f16_to_f32(load_u16(rec + 2));
    uint32_t qh = load_u32(rec + 4);
    const uint8_t* qs = rec + 8;
    float* out = dst + b * QK;
    for (int j = 0; j < 16; ++j) {
      int xh0 = ((qh >> j) << 4) & 0x10;
      int xh1 = (qh >> (j + 12)) & 0x10;
      out[j] = (((int)(qs[j] & 0x0F)) | xh0) * d + m;
      out[j + 16] = (((int)(qs[j] >> 4)) | xh1) * d + m;
    }
  }
}

void dequant_q8_0(const uint8_t* src, float* dst, int64_t nb) {
  for (int64_t b = 0; b < nb; ++b) {
    const uint8_t* rec = src + b * REC_Q8_0;
    float d = f16_to_f32(load_u16(rec));
    const int8_t* qs = reinterpret_cast<const int8_t*>(rec + 2);
    float* out = dst + b * QK;
    for (int j = 0; j < QK; ++j) out[j] = qs[j] * d;
  }
}

void dequant_f16(const uint8_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = f16_to_f32(load_u16(src + 2 * i));
}

template <typename Fn>
void parallel_blocks(Fn fn, const uint8_t* src, float* dst, int64_t nb,
                     int rec_size, int nthreads) {
  if (nthreads <= 1 || nb < 1024) {
    fn(src, dst, nb);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (nb + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min(nb, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(src + lo * rec_size, dst + lo * QK, hi - lo); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// ttype values match ckpt/ggml.py: 1=f16, 2=q4_0, 3=q4_1, 6=q5_0, 7=q5_1, 8=q8_0
// Returns 0 on success, -1 on unsupported type.
int ggml_dequantize(int ttype, const uint8_t* src, float* dst, int64_t n,
                    int nthreads) {
  if (ttype == 1) {  // F16 — split by element ranges
    if (nthreads <= 1 || n < (1 << 16)) {
      dequant_f16(src, dst, n);
    } else {
      std::vector<std::thread> threads;
      int64_t per = (n + nthreads - 1) / nthreads;
      for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * per, hi = std::min(n, lo + per);
        if (lo >= hi) break;
        threads.emplace_back([=] { dequant_f16(src + 2 * lo, dst + lo, hi - lo); });
      }
      for (auto& th : threads) th.join();
    }
    return 0;
  }
  int64_t nb = n / QK;
  switch (ttype) {
    case 2: parallel_blocks(dequant_q4_0, src, dst, nb, REC_Q4_0, nthreads); return 0;
    case 3: parallel_blocks(dequant_q4_1, src, dst, nb, REC_Q4_1, nthreads); return 0;
    case 6: parallel_blocks(dequant_q5_0, src, dst, nb, REC_Q5_0, nthreads); return 0;
    case 7: parallel_blocks(dequant_q5_1, src, dst, nb, REC_Q5_1, nthreads); return 0;
    case 8: parallel_blocks(dequant_q8_0, src, dst, nb, REC_Q8_0, nthreads); return 0;
    default: return -1;
  }
}

// PCM s16le -> f32 with 1/32768 scaling (audio ingest hot path).
void pcm16_to_f32(const int16_t* src, float* dst, int64_t n) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * kScale;
}

}  // extern "C"
