// One decode step of the MINIMALIST core, fused: both 2 b-code
// projections, the 6 b SAR-ADC gate, the capacitor-swap state update and
// the comparator, for x (B, K) fp32, codes (K, N) int8, biases (N,) fp32
// and h_prev (B, N) fp32:
//
//   pre_h = (x @ (codes_h - 1.5)) * scale + bh
//   pre_z = (x @ (codes_z - 1.5)) * scale + bz
//   zc    = floor(clip(pre_z / 6 + 1/2, 0, 1) * 63)     (the ADC code)
//   z     = zc / 63
//   h     = z * pre_h + (1 - z) * h_prev,   y = (h > 0)
//
// Replaces the TPU kernel minimalist_step_pallas
// (src/repro/kernels/minimalist_block/minimalist_block.py:84).
//
// Bound: at the paper's width (K = N = 64, B = 8 slots) the call moves a
// few tens of KB and is bound by latency: the launch, one round of loads
// and the chain of arithmetic after them; at (64, 1024 -> 1024) it does
// 4*B*K*N fp32 flops on 2*K*N bytes of codes and is bound by operations.
//
// Design: a CTA of four warps owns 16 columns for 4 * TR rows of x (TR = 2
// for up to 8 rows, the paper's slots, so each code byte leaves memory
// once a call; 4 otherwise), and the grid is column slabs x row groups.
// Lane (p, q) of warp w takes columns 4q .. 4q + 3 of rows w*TR ..
// w*TR + TR - 1 over the K rows k = p mod 8: the K sum is split over 8
// lanes, each chain 8 deep a chunk, with 8 * TR independent
// accumulators.  K is staged 64 rows at a time into a double-buffered
// shared tile with 16-byte loads (predicated byte or word loads at a
// ragged or unaligned edge): x as it is, the codes widened to their fp32
// levels once (a float trick, exact for any int8), and the next chunk's
// loads are in flight while this one is summed.  The 8 parts are then
// combined by a reduce-scatter over the three lane bits (xor 4, 2, 1),
// which leaves each lane TR/2 finished (h, z) sums:
//   ((P0 + P4) + (P2 + P6)) + ((P1 + P5) + (P3 + P7)),
// each addition commutative, so every lane holding a sum agrees.  With
// binary x every partial sum is a small multiple of 1/2, exact in fp32,
// so the result does not depend on the order and equals the plain
// version's and cuBLAS's bit for bit; analog x moves by fp32 roundings.
// The scaling, the gate and the update are written with
// __fmul_rn/__fdiv_rn/__fadd_rn so that nvcc cannot contract them: floor()
// then sees the same fp32 operations as the reference
// (minimalist_block.py:76), and the z code is exactly the plain version's
// wherever (pre_z/6 + 1/2)*63 is not within rounding of an integer.
// The codes and biases of the first chunk are loaded first, then x and
// h_prev.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kParts = 8;       // lanes splitting one K sum
constexpr int kCols = 16;       // columns of a CTA: 4 lane groups x 4
constexpr int kChunk = 64;      // K rows staged at a time
constexpr int kLv = kCols + 4;  // a level row, padded: conflict-free reads

template <int TR>
struct Stage {
  float x[4 * TR][kChunk];
  float lv[2][kChunk][kLv];     // levels of codes_h, codes_z
};

// Sixteen int8 codes -> their levels c - 1.5, exactly float(c) - 1.5f:
// the float with bits 0x4B000000 | (c ^ 0x80) is 2^23 + c + 128.
__device__ __forceinline__ void levels16(uint4 w, float (&out)[16]) {
  const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                             w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[4 * j + i] =
          __int_as_float(__byte_perm(words[j], 0x4B000000u, 0x7440 | i)) -
          8388736.0f - 1.5f;
}

// Codes row k, columns n0 .. n0 + 15 of one matrix (zeros past K or N).
__device__ __forceinline__ uint4 load_codes(const int8_t* codes, int k,
                                            int n0, int K, int N, bool vec) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (k >= K) return w;
  const int8_t* src = codes + static_cast<int64_t>(k) * N + n0;
  if (vec && n0 + 16 <= N) return *reinterpret_cast<const uint4*>(src);
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (n0 + i < N)
      b[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                  << (8 * (i % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// x row `row`, columns k .. k + 3 (zeros past B or K).
__device__ __forceinline__ float4 load_x(const float* x, int row, int k,
                                         int B, int K, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= B) return v;
  const float* src = x + static_cast<int64_t>(row) * K + k;
  if (vec && k + 4 <= K) return *reinterpret_cast<const float4*>(src);
  if (k < K) v.x = src[0];
  if (k + 1 < K) v.y = src[1];
  if (k + 2 < K) v.z = src[2];
  if (k + 3 < K) v.w = src[3];
  return v;
}

// One round of the reduce-scatter over lane bit M: v[0, 2 HALF) -> v[0,
// HALF), the lane with the bit set keeping the upper half.
template <int M, int HALF, int V>
__device__ __forceinline__ void reduce_round(float (&v)[V], int lane) {
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

template <int TR>
__global__ void __launch_bounds__(kThreads)
    minimalist_step_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ codes_h,
                           const int8_t* __restrict__ codes_z, float scale,
                           const float* __restrict__ bh,
                           const float* __restrict__ bz,
                           const float* __restrict__ h_prev,
                           float* __restrict__ y, float* __restrict__ h_out,
                           int8_t* __restrict__ z_out, int B, int K, int N) {
  constexpr int BR = 4 * TR;          // rows of a CTA
  constexpr int XQ = BR * kChunk / 4 / kThreads;   // x quads a thread
  constexpr int NO = TR / 2;          // finished outputs a lane ends with
  __shared__ __align__(16) Stage<TR> st[2];
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int p = lane % kParts, q = lane / kParts;
  const int n0 = blockIdx.x * kCols, row0 = blockIdx.y * BR;
  const int chunks = (K + kChunk - 1) / kChunk;
  const bool codes_vec =
      N % 16 == 0 && ((reinterpret_cast<uintptr_t>(codes_h) |
                       reinterpret_cast<uintptr_t>(codes_z)) % 16) == 0;
  const bool x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // staging roles: codes row (t % 64) of matrix t / 64; x quads t + 128 j
  const int8_t* my_codes = tid < kChunk ? codes_h : codes_z;
  const int ck = tid % kChunk;

  // codes and biases first, then x and h_prev
  uint4 cw = load_codes(my_codes, ck, n0, K, N, codes_vec);
  int ob[NO], on[NO];
  float bhv[NO], bzv[NO], hp[NO];
#pragma unroll
  for (int e = 0; e < NO; ++e) {
    const int o = p * NO + e;      // output o of the lane group's TR x 4
    ob[e] = row0 + w * TR + o / 4;
    on[e] = n0 + 4 * q + o % 4;
    bhv[e] = on[e] < N ? bh[on[e]] : 0.0f;
    bzv[e] = on[e] < N ? bz[on[e]] : 0.0f;
  }
  float4 xw[XQ];
#pragma unroll
  for (int j = 0; j < XQ; ++j) {
    const int quad = tid + kThreads * j;
    xw[j] = load_x(x, row0 + quad / (kChunk / 4), 4 * (quad % (kChunk / 4)),
                   B, K, x_vec);
  }
#pragma unroll
  for (int e = 0; e < NO; ++e)
    hp[e] = ob[e] < B && on[e] < N
                ? h_prev[static_cast<int64_t>(ob[e]) * N + on[e]]
                : 0.0f;

  float acc[TR][4][2];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = 0.0f;

  for (int ch = 0; ch < chunks; ++ch) {
    // st[ch & 1] was last read in chunk ch - 2, before chunk ch - 1's
    // barrier, which every thread has passed
    Stage<TR>& s = st[ch & 1];
    float lv[16];
    levels16(cw, lv);
    float* dst = s.lv[tid / kChunk][ck];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + 4 * j) =
          make_float4(lv[4 * j], lv[4 * j + 1], lv[4 * j + 2], lv[4 * j + 3]);
#pragma unroll
    for (int j = 0; j < XQ; ++j) {
      const int quad = tid + kThreads * j;
      *reinterpret_cast<float4*>(
          &s.x[quad / (kChunk / 4)][4 * (quad % (kChunk / 4))]) = xw[j];
    }
    __syncthreads();
    if (ch + 1 < chunks) {      // the next chunk's loads fly during the sums
      const int k0 = (ch + 1) * kChunk;
      cw = load_codes(my_codes, k0 + ck, n0, K, N, codes_vec);
#pragma unroll
      for (int j = 0; j < XQ; ++j) {
        const int quad = tid + kThreads * j;
        xw[j] = load_x(x, row0 + quad / (kChunk / 4),
                       k0 + 4 * (quad % (kChunk / 4)), B, K, x_vec);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk / kParts; ++i) {
      const int kk = p + kParts * i;
      const float4 lh = *reinterpret_cast<const float4*>(&s.lv[0][kk][4 * q]);
      const float4 lz = *reinterpret_cast<const float4*>(&s.lv[1][kk][4 * q]);
      const float lhv[4] = {lh.x, lh.y, lh.z, lh.w};
      const float lzv[4] = {lz.x, lz.y, lz.z, lz.w};
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float xv = s.x[w * TR + r][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c][0] = fmaf(xv, lhv[c], acc[r][c][0]);
          acc[r][c][1] = fmaf(xv, lzv[c], acc[r][c][1]);
        }
      }
    }
  }

  // reduce-scatter over the 8 part lanes of v[(r * 4 + c) * 2 + mat]
  float v[8 * TR];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[(r * 4 + c) * 2] = acc[r][c][0];
      v[(r * 4 + c) * 2 + 1] = acc[r][c][1];
    }
  reduce_round<4, 4 * TR>(v, lane);
  reduce_round<2, 2 * TR>(v, lane);
  reduce_round<1, TR>(v, lane);

#pragma unroll
  for (int e = 0; e < NO; ++e) {
    const int b = ob[e], n = on[e];
    if (b >= B || n >= N) continue;
    const float pre_h = __fadd_rn(__fmul_rn(v[2 * e], scale), bhv[e]);
    const float pre_z = __fadd_rn(__fmul_rn(v[2 * e + 1], scale), bzv[e]);
    // SAR-ADC transfer: mid-rise floor on the 63-unit capacitor grid
    const float vz = fminf(
        fmaxf(__fadd_rn(__fdiv_rn(pre_z, 6.0f), 0.5f), 0.0f), 1.0f);
    const float code = floorf(__fmul_rn(vz, 63.0f));
    const float z = __fdiv_rn(code, 63.0f);
    const int64_t o = static_cast<int64_t>(b) * N + n;
    // capacitor-swap update and comparator
    const float h = __fadd_rn(__fmul_rn(z, pre_h),
                              __fmul_rn(__fsub_rn(1.0f, z), hp[e]));
    h_out[o] = h;
    y[o] = h > 0.0f ? 1.0f : 0.0f;
    if (z_out != nullptr) z_out[o] = static_cast<int8_t>(code);
  }
}

template <int TR>
int launch(const void* x, const void* codes_h, const void* codes_z,
           float scale, const void* bh, const void* bz, const void* h_prev,
           void* y, void* h_out, void* z_out, int B, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (B + 4 * TR - 1) / (4 * TR));
  minimalist_step_kernel<TR><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes_h),
      static_cast<const int8_t*>(codes_z), scale,
      static_cast<const float*>(bh), static_cast<const float*>(bz),
      static_cast<const float*>(h_prev), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<int8_t*>(z_out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int minimalist_step_f32(const void* x, const void* codes_h,
                                   const void* codes_z, float scale,
                                   const void* bh, const void* bz,
                                   const void* h_prev, void* y, void* h_out,
                                   void* z_out, int B, int K, int N,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return B <= 8 ? launch<2>(x, codes_h, codes_z, scale, bh, bz, h_prev, y,
                            h_out, z_out, B, K, N, s)
                : launch<4>(x, codes_h, codes_z, scale, bh, bz, h_prev, y,
                            h_out, z_out, B, K, N, s);
}
