// The port's own copy of speaksense_tpu/native/sanitize_test.cc.
//
// Sanitizer harness for the native kernels (SURVEY.md §5: "the C++ portions
// we write should be TSAN/ASAN-clean in CI"). Exercises every exported entry
// point, including the multi-threaded block paths (nb >= 1024 so
// parallel_blocks actually spawns threads), under ASAN/UBSAN or TSAN
// (speaksense_tpu_torch/native/build.py: build_sanitizer).
//
// Build (from repo root):
//   g++ -fsanitize=address,undefined -g -O1 -std=c++17 -pthread \
//       speaksense_tpu_torch/native/ggml_kernels.cc \
//       speaksense_tpu_torch/native/sanitize_test.cc -o /tmp/ss_asan && /tmp/ss_asan
//   g++ -fsanitize=thread -g -O1 ... -o /tmp/ss_tsan && /tmp/ss_tsan

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int ggml_dequantize(int ttype, const uint8_t* src, float* dst, int64_t n,
                    int nthreads);
void pcm16_to_f32(const int16_t* src, float* dst, int64_t n);
}

namespace {

constexpr int64_t QK = 32;

// record sizes per ggml type (mirrors ckpt/ggml.py block layouts)
int rec_size(int ttype) {
  switch (ttype) {
    case 2: return 2 + 16;       // q4_0: f16 scale + 16 nibble bytes
    case 3: return 4 + 16;       // q4_1: f16 scale + f16 min + nibbles
    case 6: return 2 + 4 + 16;   // q5_0: scale + 32 high bits + nibbles
    case 7: return 4 + 4 + 16;   // q5_1: scale + min + high bits + nibbles
    case 8: return 2 + 32;       // q8_0: scale + 32 int8
    default: return 0;
  }
}

int check(int ttype, int64_t nb, int nthreads) {
  std::vector<uint8_t> src(static_cast<size_t>(nb) * rec_size(ttype));
  for (size_t i = 0; i < src.size(); ++i) src[i] = static_cast<uint8_t>(i * 2654435761u);
  std::vector<float> dst(static_cast<size_t>(nb) * QK, -1.0f);
  int rc = ggml_dequantize(ttype, src.data(), dst.data(), nb * QK, nthreads);
  if (rc != 0) {
    std::fprintf(stderr, "dequantize(%d) rc=%d\n", ttype, rc);
    return 1;
  }
  // touch every output element (sanitizers flag uninitialized/oob reads);
  // random f16 scales legitimately produce NaN/inf values, so only keep the
  // read loop un-elided, don't check the sum
  volatile double sum = 0;
  for (float v : dst) sum += v;
  (void)sum;
  return 0;
}

}  // namespace

int main() {
  int fails = 0;
  for (int ttype : {2, 3, 6, 7, 8}) {
    fails += check(ttype, 8, 1);        // serial path
    fails += check(ttype, 4096, 8);     // threaded path (nb >= 1024)
  }
  // f16: serial + threaded element split
  {
    const int64_t n = 1 << 18;
    std::vector<uint8_t> src(n * 2);
    for (size_t i = 0; i < src.size(); ++i) src[i] = static_cast<uint8_t>(i);
    std::vector<float> dst(n);
    fails += ggml_dequantize(1, src.data(), dst.data(), 256, 1) != 0;
    fails += ggml_dequantize(1, src.data(), dst.data(), n, 8) != 0;
  }
  // unsupported type must fail cleanly, not crash
  {
    uint8_t b[64] = {0};
    float f[64];
    fails += ggml_dequantize(99, b, f, 64, 4) != -1;
  }
  {
    std::vector<int16_t> pcm(48000);
    for (size_t i = 0; i < pcm.size(); ++i) pcm[i] = static_cast<int16_t>(i * 7);
    std::vector<float> out(pcm.size());
    pcm16_to_f32(pcm.data(), out.data(), static_cast<int64_t>(pcm.size()));
    if (out[1] <= 0.0f) ++fails;
  }
  std::printf(fails ? "SANITIZE FAIL (%d)\n" : "SANITIZE OK\n", fails);
  return fails ? 1 : 0;
}
