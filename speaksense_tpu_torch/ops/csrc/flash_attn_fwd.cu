// Flash-attention forward for the Whisper encoder, hand-written for Hopper
// (sm_90a).
//
// Replaces: speaksense_tpu/ops/flash.py::flash_attention_full, which calls
// jax's stock Pallas TPU flash_attention (the forward pl.pallas_call in
// _flash_attention_impl) from W.encode. This file computes the same function,
// not the TPU kernel's blocks: non-causal softmax(Q K^T * Dh^-0.5) V over bf16
// q, k, v of shape (B, H, T, Dh = 64) with any Dh-contiguous strides, f32
// softmax statistics and accumulators, bf16 output. Keys at index >= T are
// masked inside the kernel (no host padding); query rows >= T are never
// written. Masked logits use the finite -1e30 of the reference, never -inf.
// As in the reference (_attention casts the softmax weights to bf16 before
// the PV product), the probabilities enter the PV product as bf16.
//
// What bounds it on an H100: at the production shape (B = 8, H = 20,
// T = 1500, Dh = 64) one layer's attention is 4*B*H*T^2*Dh = 92 GFLOP
// against 98 MB of q, k, v and o, about 940 FLOP per byte. The card's ridge
// point is near 295 FLOP per byte (published H100 SXM peaks at 700 W:
// 989 TFLOP/s bf16 dense, 3.35 TB/s), so the tensor cores bound it, not
// memory.
//
// The simple design: one CTA per (batch, head, 64-query tile), 4 warps of
// 16 query rows each. The CTA stages 64-key K and V tiles in shared memory
// (rows padded to 72 elements so fragment loads are free of bank conflicts),
// computes Q K^T and P V with mma.sync.m16n8k16 bf16 tensor-core
// instructions, and keeps the online-softmax state in registers. The P
// accumulator fragments are reused directly as the A operand of the P V
// product. What it leaves for later: no cp.async/TMA pipelining (loads and
// math do not overlap), V fragments are gathered with 16-bit shared loads
// instead of ldmatrix.trans, and no wgmma or warp specialisation, so it
// cannot reach the wgmma-only share of the tensor-core peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;
constexpr int kBlockM = 64;   // query rows per CTA
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;     // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kDh + 8;  // padded shared-memory row (elements)
constexpr float kMaskValue = -1e30f;

using bf16 = __nv_bfloat16;

// Copy rows [row0, row0 + 64) of one (T, Dh) head into shared memory, 16
// bytes per thread per step; rows past T are zero-filled so that masked
// probabilities (exactly 0) never multiply uninitialised values.
__device__ __forceinline__ void load_tile(bf16 (*dst)[kLd], const bf16* src,
                                          int64_t row_stride, int row0, int T) {
  for (int c = threadIdx.x; c < kBlockN * (kDh / 8); c += kThreads) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int T,
                      int64_t q_sb, int64_t q_sh, int64_t q_st,
                      int64_t k_sb, int64_t k_sh, int64_t k_st,
                      int64_t v_sb, int64_t v_sh, int64_t v_st,
                      int64_t o_sb, int64_t o_sh, int64_t o_st, float scale) {
  __shared__ __align__(16) bf16 sQ[kBlockM][kLd];
  __shared__ __align__(16) bf16 sK[kBlockN][kLd];
  __shared__ __align__(16) bf16 sV[kBlockN][kLd];

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qh = q + b * q_sb + h * q_sh;
  const bf16* kh = k + b * k_sb + h * k_sh;
  const bf16* vh = v + b * v_sb + h * v_sh;
  bf16* oh = o + b * o_sb + h * o_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int r0 = warp * 16 + g;

  load_tile(sQ, qh, q_st, m0, T);
  __syncthreads();

  // Q fragments (A operand) for the 4 k-steps of 16 head dims, kept in
  // registers for the whole key loop.
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t4 * 2;
    qa[ks][0] = ld_u32(&sQ[r0][c]);
    qa[ks][1] = ld_u32(&sQ[r0 + 8][c]);
    qa[ks][2] = ld_u32(&sQ[r0][c + 8]);
    qa[ks][3] = ld_u32(&sQ[r0 + 8][c + 8]);
  }

  // acc[nt]: output dims nt*8 + t4*2 + {0,1} of rows r0 ({0,1}) and r0+8 ({2,3})
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  float m_i[2] = {kMaskValue, kMaskValue};
  float l_i[2] = {0.f, 0.f};

  const int n_tiles = (T + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kh, k_st, n0, T);
    load_tile(sV, vh, v_st, n0, T);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kr = &sK[nt * 8 + g][ks * 16 + t4 * 2];
        mma_bf16(s[nt], qa[ks], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // scale, mask the tail keys, row max over the 4 threads of a row group
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + t4 * 2 + (e & 1);
        const float x = col < T ? s[nt][e] * scale : kMaskValue;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new[r]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_new[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_i[r] = l_i[r] * alpha[r] + rs[r];
      m_i[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    }

    // O += P V: the S accumulators of key tiles 2kk and 2kk+1 are exactly
    // the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + t4 * 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = nt * 8 + g;
        const uint32_t b0 = pack_bf16(sV[key][d], sV[key + 1][d]);
        const uint32_t b1 = pack_bf16(sV[key + 8][d], sV[key + 9][d]);
        mma_bf16(acc[nt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + r * 8;
    if (row < T) {
      const float inv = 1.f / l_i[r];
      bf16* orow = oh + (int64_t)row * o_st;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
      }
    }
  }
}

}  // namespace

// Strides are in elements; the last (Dh) dimension must be contiguous and
// every row 16-byte aligned (checked by the Python wrapper). Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int T,
                                   int64_t q_sb, int64_t q_sh, int64_t q_st,
                                   int64_t k_sb, int64_t k_sh, int64_t k_st,
                                   int64_t v_sb, int64_t v_sh, int64_t v_st,
                                   int64_t o_sb, int64_t o_sh, int64_t o_st,
                                   float scale, void* stream) {
  const dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  flash_attn_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), T, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
      o_sb, o_sh, o_st, scale);
  return static_cast<int>(cudaGetLastError());
}
