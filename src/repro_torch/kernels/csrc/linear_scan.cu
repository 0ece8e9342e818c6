// Diagonal linear recurrence  h_t = a_t * h_{t-1} + b_t  over axis 1 of
// (B, T, D) tensors, fp32 carry, output in the input type.
//
// Replaces the TPU kernel linear_scan_pallas
// (src/repro/kernels/linear_scan/linear_scan.py:54), which walks the time
// chunks of a (B, D/dblk, T/tblk) grid in order and carries h in VMEM.
//
// Bound: memory.  Each element of a and b is read once and each h written
// once (2 flops per 3 elements), so the least time is the bytes over the
// card's memory rate: 3*B*T*D*sizeof(T) for the main path.
//
// Design: one thread per (b, d) channel, threads along d so that a warp
// reads 32 neighbouring elements of one time step.  The carry stays in a
// register for the whole sequence; the time loop is unrolled by kUnroll
// with all loads of a group issued before the dependent FMAs, so several
// loads are in flight per thread.  Ragged D is masked, not padded.  With
// B*D threads only (3840 on the LM's prefill chunk), the card is far from
// full: a chunked scan across T is the next step, not this one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ h0, T* __restrict__ out,
                       int steps, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * static_cast<int64_t>(steps) * D + d;
  const T* ap = a + base;
  const T* bp = b + base;
  T* op = out + base;
  float h = load_f(h0 + row * D + d);
  int t = 0;
  for (; t + kUnroll <= steps; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = load_f(ap + static_cast<int64_t>(t + u) * D);
      bv[u] = load_f(bp + static_cast<int64_t>(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      store_f(op + static_cast<int64_t>(t + u) * D, h);
    }
  }
  for (; t < steps; ++t) {
    const int64_t off = static_cast<int64_t>(t) * D;
    h = fmaf(load_f(ap + off), h, load_f(bp + off));
    store_f(op + off, h);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, int B,
           int steps, int D, void* stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  linear_scan_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(h0), static_cast<T*>(out), steps, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int linear_scan_f32(const void* a, const void* b, const void* h0,
                               void* out, int B, int steps, int D,
                               void* stream) {
  return launch<float>(a, b, h0, out, B, steps, D, stream);
}

extern "C" int linear_scan_bf16(const void* a, const void* b, const void* h0,
                                void* out, int B, int steps, int D,
                                void* stream) {
  return launch<__nv_bfloat16>(a, b, h0, out, B, steps, D, stream);
}
