// Flash attention: what flash_fwd.cu and flash_bwd.cu share (layouts,
// the mask, tile skipping), and the tiles of their CUDA-core (simt)
// route; the tensor-core (tc) route's are in flash_tc.cuh.
//
// Layouts: q (B, H, S, D); k, v (B, KV, S, D), H % KV == 0, query head h
// reads kv head h / (H / KV).  Every (B, H, S, D) tensor is passed as a
// pointer and its (batch, head, row) strides in elements; the last axis
// is contiguous.  So the model can hand over its (B, S, H, D) projections
// as transposed views, and the outputs are written in the same layout,
// with no copies.  lse and delta are contiguous (B, H, S) fp32.
//
// Numerics are the TPU kernels' (src/repro/kernels/flash_attention/
// flash_attention.py): fp32 products of the inputs, s = q.k * scale plus
// an ADDITIVE mask of -1e30 (not -inf), an fp32 online softmax, fp32
// accumulators, results rounded once to the inputs' type.  With -1e30 a
// row whose first visited tile is fully masked (a sliding window) gets
// m = -1e30 and p = exp(0) = 1 on every entry of that tile; the next
// tile with a real entry wipes them out through alpha = exp(-1e30 - m) =
// 0, exactly as in the TPU kernel.  -inf would give (-inf) - (-inf) =
// NaN there, and a fast exp would not reach 0: these sources use expf
// (the tc route exp2f, flash_tc.cuh) and are built without
// --use_fast_math.
//
// simt tiles: 256 threads as 16 x 16.  A thread owns rows ty*R .. ty*R+R-1 of
// a tile and columns tx, tx+16, tx+32, ... of it, so the 16 threads of a
// row are the 16 lanes of one half-warp and a row's max and sum are four
// xor-shuffles.  Tiles live in shared memory as fp32 with a row stride
// of D+1 (or BK+1), which keeps the column reads of the 16 lanes in 16
// different banks.  Any S: rows past S are loaded as zeros, masked, and
// never stored, and keys past S are masked.  Any head dim up to 256: it
// runs at the next compiled one (FLASH_DISPATCH_D) with the columns past
// it loaded as zeros and never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Additive mask of (query row, key col): 0 where the query may attend
// the key, -1e30 elsewhere and for rows or keys past S.
__device__ __forceinline__ float mask(int row, int col, int S, int causal,
                                      int window) {
  bool ok = row < S && col < S;
  if (causal) ok = ok && row >= col;
  if (window >= 0) ok = ok && (row - col) < window;
  return ok ? 0.0f : kNegInf;
}

// The KV tiles [lo, hi] that a query tile of rows [q0, q_last] must
// visit: a tile wholly above the diagonal, or wholly before the window
// of the tile's first row, holds no attendable entry (the skip of the
// TPU kernel, flash_attention.py:66-73).
__device__ __forceinline__ void kv_tiles(int q0, int q_last, int BK, int S,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *hi = causal ? q_last / BK : (S - 1) / BK;
  *lo = 0;
  if (window >= 0 && q0 - window + 1 > 0) *lo = (q0 - window + 1) / BK;
}

// The query tiles [lo, hi] that can attend a KV tile of keys
// [k0, k0 + BK - 1]: the converse of kv_tiles.
__device__ __forceinline__ void q_tiles(int k0, int BK, int BQ, int S,
                                        int causal, int window, int* lo,
                                        int* hi) {
  *lo = causal ? k0 / BQ : 0;
  *hi = (S - 1) / BQ;
  if (window >= 0) {
    const int last = (k0 + BK - 2 + window) / BQ;
    if (last < *hi) *hi = last;
  }
}

// ROWS rows of D values from global memory (row stride `ld` elements,
// first row `row0`) into shared memory as fp32 at row stride D + 1;
// rows at or past S, and columns at or past the true head dim `dim`
// (<= D, the compiled one), become zeros.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int row0, int S,
                                          int dim) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[r * (D + 1) + d] = s < S && d < dim ? to_f(src[s * ld + d]) : 0.0f;
  }
}

// Max and sum over the 16 lanes of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1/sqrt(D) as the plain version and the TPU kernel round it: a double,
// once to fp32.
inline float softmax_scale(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Raise the dynamic shared memory limit of `kernel` before a launch.  On
// every launch: the attribute belongs to the current device's context (a
// flag kept once a process would skip a second card), and a host-side
// call costs less than a microsecond.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace flash

// Instantiate `FN<T, D, BQ, BK>(args...)` of the simt route at the
// smallest compiled head dim that holds the true one (1 to 256): 16, 32,
// 64, 128, 160 or 256, in fp32 and bf16.  A true head dim below the
// compiled one runs with its extra columns zero in shared memory (they
// add nothing to q.k, and the output columns they would give are not
// stored); the softmax scale is the true dim's, passed in the params.
// Tiles are 64 x 64, and 32 x 32 at D = 256 where the backward's six
// fp32 tiles would not fit in shared memory at 64.  The bf16 head dims of
// the tc route (16/32/64/128 and 129-256) take flash_tc.cuh unless called
// here.
#define FLASH_DISPATCH_D(D, FN, T, ...)                          \
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue); \
  if (D <= 16) return FN<T, 16, 64, 64>(__VA_ARGS__);            \
  if (D <= 32) return FN<T, 32, 64, 64>(__VA_ARGS__);            \
  if (D <= 64) return FN<T, 64, 64, 64>(__VA_ARGS__);            \
  if (D <= 128) return FN<T, 128, 64, 64>(__VA_ARGS__);          \
  if (D <= 160) return FN<T, 160, 64, 64>(__VA_ARGS__);          \
  return FN<T, 256, 32, 32>(__VA_ARGS__);
