// Fused selective scan (Mamba-1 SSM core): what fused_ssm_fwd.cu and
// fused_ssm_bwd.cu share.
//
//   a_t = exp(dt_t * A)   h_t = a_t * h_{t-1} + (dt_t * x_t) B_t
//   y_t = sum_n h_t C_t
//
// Layouts (fp32, contiguous): dt, x, y (B, T, di); Bm, Cm (B, T, n);
// A (di, n); the chunk-entry states h_entries (B, ceil(T / kChunk), di,
// n), h_entries[b, c] being the state before step c * kChunk.
//
// Threads: one per (batch, channel d, state index n).  A block has
// kThreads threads; the NL lanes of one d (NL = the power of two >= n,
// n <= 32) are neighbours in a warp, so each lane owns one (d, n) pair of
// the recurrence, a block covers DB = kThreads / NL channels of one batch
// row, and a sum over n is log2(NL) xor-shuffles.  Lanes past n hold A =
// B = C = 0, so their state stays 0 and they add exact zeros to every sum;
// channels past di are staged as zeros the same way.  Time runs in chunks
// of kChunk steps: each chunk's dt and x (and dy) columns of the block and
// its B and C rows are staged in shared memory (coalesced; zeros past T
// and di), then the threads walk the chunk.
//
// Numerics: every product and sum rounded on its own (__fmul_rn /
// __fadd_rn, no contraction into FMAs), accurate expf, no fast math: the
// plain versions (kernels/fused_ssm/ref.py) take the same ops in the same
// order except the sums over n and d, which they take in another order.
// No atomics: two calls give bitwise the same results.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;

// The power of two >= n for 1 <= n <= 32; 0 for any other n.
inline int lanes_for(int n) {
  if (n < 1 || n > 32) return 0;
  int l = 1;
  while (l < n) l <<= 1;
  return l;
}

// Copies rows [t0, t0 + len) of columns [col0, col0 + W) of a (rows, ncols)
// matrix starting at row `row0` into dst[kChunk][W]; zeros past len and
// past ncols.
template <int W>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int64_t row0, int ncols, int col0,
                                      int len, float* dst) {
  for (int i = threadIdx.x; i < kChunk * W; i += kThreads) {
    const int tt = i / W, col = col0 + i - tt * W;
    dst[i] = (tt < len && col < ncols) ? src[(row0 + tt) * ncols + col]
                                       : 0.0f;
  }
}

// Sum of v over the lanes whose indices differ in the bits [lo, hi) of
// the lane number, left in every one of them.
template <int LO, int HI>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = LO; o < HI; o <<= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool* done) {
  if (*done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace ssm

// Instantiate `FN<NL>(args...)` for the lane counts the kernels take.
#define SSM_DISPATCH_LANES(NL, FN, ...)                      \
  switch (NL) {                                              \
    case 1: return FN<1>(__VA_ARGS__);                       \
    case 2: return FN<2>(__VA_ARGS__);                       \
    case 4: return FN<4>(__VA_ARGS__);                       \
    case 8: return FN<8>(__VA_ARGS__);                       \
    case 16: return FN<16>(__VA_ARGS__);                     \
    case 32: return FN<32>(__VA_ARGS__);                     \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
