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
// Bound: at the paper's width (K = N = 64, B = slots) the call moves a few
// tens of KB and is bound by launch latency; at (64, 1024 -> 1024) it does
// 4*B*K*N fp32 flops on 2*K*N bytes of codes and is bound by operations.
//
// Design: one thread per (b, n) output, threads along n so that a warp
// reads 32 neighbouring code bytes per k; x[b, k] is the same address for
// the whole block (a broadcast).  The weights stay int8 in memory and are
// turned into levels in registers.  Both sums add the 2 b levels (the
// array's own order, paper Eq. 6) and are scaled by Delta once: with binary
// x every partial sum is a small multiple of 1/2, exact in fp32, so the
// result does not depend on the summation order and equals the plain
// version's and cuBLAS's bit for bit.  The scaling, the gate and the update
// are written with __fmul_rn/__fdiv_rn/__fadd_rn so that nvcc cannot
// contract them: floor() then sees the same fp32 operations as the
// reference (minimalist_block.py:76), and the z code is exactly the plain
// version's wherever (pre_z/6 + 1/2)*63 is not within rounding of an
// integer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    minimalist_step_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ codes_h,
                           const int8_t* __restrict__ codes_z, float scale,
                           const float* __restrict__ bh,
                           const float* __restrict__ bz,
                           const float* __restrict__ h_prev,
                           float* __restrict__ y, float* __restrict__ h_out,
                           int8_t* __restrict__ z_out, int K, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int64_t row = blockIdx.y;
  const float* xr = x + row * K;
  float acc_h = 0.0f;
  float acc_z = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float xk = xr[k];
    const int64_t off = static_cast<int64_t>(k) * N + n;
    acc_h = fmaf(xk, static_cast<float>(codes_h[off]) - 1.5f, acc_h);
    acc_z = fmaf(xk, static_cast<float>(codes_z[off]) - 1.5f, acc_z);
  }
  const float pre_h = __fadd_rn(__fmul_rn(acc_h, scale), bh[n]);
  const float pre_z = __fadd_rn(__fmul_rn(acc_z, scale), bz[n]);
  // SAR-ADC transfer: mid-rise floor on the 63-unit capacitor grid
  const float v = fminf(fmaxf(__fadd_rn(__fdiv_rn(pre_z, 6.0f), 0.5f), 0.0f),
                        1.0f);
  const float code = floorf(__fmul_rn(v, 63.0f));
  const float z = __fdiv_rn(code, 63.0f);
  const int64_t o = row * N + n;
  // capacitor-swap update and comparator
  const float h = __fadd_rn(__fmul_rn(z, pre_h),
                            __fmul_rn(__fsub_rn(1.0f, z), h_prev[o]));
  h_out[o] = h;
  y[o] = h > 0.0f ? 1.0f : 0.0f;
  if (z_out != nullptr) z_out[o] = static_cast<int8_t>(code);
}

}  // namespace

extern "C" int minimalist_step_f32(const void* x, const void* codes_h,
                                   const void* codes_z, float scale,
                                   const void* bh, const void* bz,
                                   const void* h_prev, void* y, void* h_out,
                                   void* z_out, int B, int K, int N,
                                   void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  minimalist_step_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes_h),
      static_cast<const int8_t*>(codes_z), scale,
      static_cast<const float*>(bh), static_cast<const float*>(bz),
      static_cast<const float*>(h_prev), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<int8_t*>(z_out), K, N);
  return static_cast<int>(cudaGetLastError());
}
