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
// Threads: a block covers CB channels of one batch row with NL lanes a
// channel (NL 1 or 2, neighbours in a warp), and each lane owns S of its
// channel's states in registers (S * NL = NP, the power of two >= n), so
// the terms of one (t, d) -- dt, x, dy, u = dt * x -- are formed once a
// lane and the sums over n are register adds plus, at NL 2, one
// xor-shuffle.  States past n hold A = B = C = 0 and channels past di are
// staged as zeros, so they stay 0 and add exact zeros to every sum.
// Config (config_for): n <= 16 -> S = NP, NL 1, CB 256; 16 < n <= 32 ->
// S 16, NL 2, CB 128; 256 threads a block either way.
//
// Time runs in stages of a few steps whose dt, x (dy) columns and B (C)
// rows are copied by 16-byte cp.async (4-byte where a row is not 16-byte
// aligned; zeros past T, di and n) into a ring of shared-memory slots, the
// copies of later stages in flight while a stage is walked; the ring's
// barrier, one a stage, is the only block-wide barrier of the walk.
//
// Numerics: a = 2^(dt * A log2(e)) by one ex2.approx (A scaled once a
// (d, n)); products and sums are left to nvcc, which contracts a product
// and a sum into an FMA (h = a h + u B, y += h C, and the backward's sums).
// The plain versions (kernels/fused_ssm/ref.py) round exp, every product
// and every sum on its own and sum over n and d in another order; the
// difference stays within the reference's tolerances.  No atomics: two
// calls give bitwise the same results.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssm {

constexpr int kChunk = 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The states a lane, lanes a channel and channels a block for state size
// n (1 <= n <= 32); S 0 for any other n.
struct Config {
  int S, NL, CB;
};
inline Config config_for(int n) {
  if (n < 1 || n > 32) return {0, 0, 0};
  int np = 1;
  while (np < n) np <<= 1;
  return np <= 16 ? Config{np, 1, 256} : Config{16, 2, 128};
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One cp.async of 16 (or 4) bytes that reads `bytes` of them (0 or all)
// and zero-fills the rest.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a ROWS x COLS tile of a matrix with row stride `gs` starting at
// `src` into dst (row stride COLS) by THREADS threads: zeros past row
// `vrows` and column `vcols`.  With `vec` (COLS, gs and vcols multiples
// of 4 and src 16-byte aligned) in 16-byte copies, else in 4-byte ones.
// A thread copies one column of every THREADS / (chunks a row)-th row,
// so its addresses are one base and compile-time row steps; a copy past
// the tile's valid rows or columns reads nothing (src-size 0), so its
// address is never dereferenced.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t gs, int vrows, int vcols,
                                          bool vec) {
  static_assert(THREADS % COLS == 0, "a tile row divides the block");
  if (COLS % 4 == 0 && vec) {
    constexpr int Q = COLS % 4 == 0 ? COLS / 4 : 1;   // chunks a row
    constexpr int RS = THREADS / Q;
    const int r0 = threadIdx.x / Q, c = 4 * (threadIdx.x % Q);
    const bool cok = c < vcols;
    const float* s = src + r0 * gs + c;
    float* d = dst + r0 * COLS + c;
#pragma unroll
    for (int r = 0; r < ROWS; r += RS) {
      if (ROWS % RS == 0 || r0 + r < ROWS) {
        cp16(d + r * COLS, s + r * gs, cok && r0 + r < vrows ? 16 : 0);
      }
    }
  } else {
    constexpr int RS = THREADS / COLS;
    const int r0 = threadIdx.x / COLS, c = threadIdx.x % COLS;
    const bool cok = c < vcols;
    const float* s = src + r0 * gs + c;
    float* d = dst + r0 * COLS + c;
#pragma unroll
    for (int r = 0; r < ROWS; r += RS) {
      if (ROWS % RS == 0 || r0 + r < ROWS) {
        cp4(d + r * COLS, s + r * gs, cok && r0 + r < vrows ? 4 : 0);
      }
    }
  }
}

// v[s] = p[s] for s < S, in 16-byte loads where S allows (p 16-byte
// aligned).
template <int S>
__device__ __forceinline__ void load_row(const float* p, float (&v)[S]) {
  if (S % 4 == 0) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + s);
      v[s] = q.x;
      v[s + 1] = q.y;
      v[s + 2] = q.z;
      v[s + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p[s];
  }
}

// Stores the first `valid` of a lane's S states at p (16-byte stores
// when `vec`: p 16-byte aligned and valid == S).
template <int S>
__device__ __forceinline__ void store_states(float* p, const float (&v)[S],
                                             int valid, bool vec) {
  if (S % 4 == 0 && vec && valid == S) {
#pragma unroll
    for (int s = 0; s < S; s += 4)
      *reinterpret_cast<float4*>(p + s) =
          make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s < valid) p[s] = v[s];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lets Kernel take `smem` bytes of dynamic shared memory.  On every
// launch: the attribute belongs to the current device's context (a flag
// kept once a process would skip a second card), and a host-side call
// costs less than a microsecond.
template <auto Kernel>
cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// What the build made of Kernel, launched as a block of `threads` threads
// over `channels` channels with `smem` bytes: out = {registers a thread,
// local (spill and stack) bytes a thread, smem, resident blocks an SM,
// threads, channels}.
template <auto Kernel>
int kernel_info(int threads, int channels, int smem, int* out) {
  cudaError_t err = allow_smem<Kernel>(smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, Kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int info[6] = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
                       smem, blocks, threads, channels};
  for (int i = 0; i < 6; ++i) out[i] = info[i];
  return 0;
}

}  // namespace ssm

// Instantiate `FN<S, NL, CB>(args...)` for the configuration of n.
#define SSM_CASE(S, NL, CB, FN, ...) \
  case S * 4 + NL: return FN<S, NL, CB>(__VA_ARGS__);
#define SSM_DISPATCH(n, FN, ...)                                        \
  {                                                                     \
    const ssm::Config cfg_ = ssm::config_for(n);                        \
    switch (cfg_.S * 4 + cfg_.NL) {                                     \
      SSM_CASE(1, 1, 256, FN, __VA_ARGS__)                              \
      SSM_CASE(2, 1, 256, FN, __VA_ARGS__)                              \
      SSM_CASE(4, 1, 256, FN, __VA_ARGS__)                              \
      SSM_CASE(8, 1, 256, FN, __VA_ARGS__)                              \
      SSM_CASE(16, 1, 256, FN, __VA_ARGS__)                             \
      SSM_CASE(16, 2, 128, FN, __VA_ARGS__)                             \
      default: return static_cast<int>(cudaErrorInvalidValue);          \
    }                                                                   \
  }
