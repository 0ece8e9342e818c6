// The MINIMALIST core over a whole sequence, fused: at every step t both
// 2 b-code projections, the 6 b SAR-ADC gate, the capacitor-swap state
// update and the comparator, for x (B, T, K) fp32 binary, codes (K, N)
// int8, biases (N,) fp32 and h0 (B, N) fp32:
//
//   pre_h = (x_t @ (codes_h - 1.5)) * scale + bh
//   pre_z = (x_t @ (codes_z - 1.5)) * scale + bz
//   z     = floor(clip(pre_z / 6 + 1/2, 0, 1) * 63) / 63
//   h_t   = z * pre_h + (1 - z) * h_{t-1},   y_t = (h_t > 0)
//
// Outputs y and h, both (B, T, N) fp32.
//
// Replaces the TPU kernel minimalist_block_pallas
// (src/repro/kernels/minimalist_block/minimalist_block.py:125, _kernel :35),
// which walks time chunks of a (B, N/nblk, T/tblk) grid in order, runs both
// projections of a chunk on the MXU and carries h in VMEM.
//
// Bound: at the paper's shape (B, 784, 64 -> 64) it does 4*B*T*K*N flops
// on fp32 and moves B*T*K*4 bytes of x in and 2*B*T*N*4 bytes out, so it is
// bound by bytes (about 1 flop per byte, far below the card's ridge).
//
// Design: one thread per (b, n) output channel, threads along n so that a
// warp reads 32 neighbouring code bytes per k; x[b, t, k] is the same
// address for the whole block (a broadcast).  h stays in a register for
// the whole sequence; the codes stay int8 in memory and become levels in
// registers.  The order is the port's: sum the 2 b levels over the binary
// x, then scale by Delta once — with binary x every partial sum is a small
// multiple of 1/2, exact in fp32 in any order.  The scaling, the gate and
// the update are spelled with __fmul_rn/__fdiv_rn/__fadd_rn/__fsub_rn so
// that nvcc cannot contract them: the kernel then agrees bit for bit with
// its plain version (ref.minimalist_block_ref), which runs the same fp32
// operations one at a time.  The projections do not depend on h and could
// run across T in parallel; a chunked two-phase kernel is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    minimalist_block_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ codes_h,
                            const int8_t* __restrict__ codes_z, float scale,
                            const float* __restrict__ bh,
                            const float* __restrict__ bz,
                            const float* __restrict__ h0,
                            float* __restrict__ y, float* __restrict__ h_out,
                            int steps, int K, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int64_t row = blockIdx.y;
  const float bias_h = bh[n];
  const float bias_z = bz[n];
  float h = h0[row * N + n];
  for (int t = 0; t < steps; ++t) {
    const float* xr = x + (row * steps + t) * static_cast<int64_t>(K);
    float acc_h = 0.0f;
    float acc_z = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float xk = xr[k];
      const int64_t off = static_cast<int64_t>(k) * N + n;
      acc_h = fmaf(xk, static_cast<float>(codes_h[off]) - 1.5f, acc_h);
      acc_z = fmaf(xk, static_cast<float>(codes_z[off]) - 1.5f, acc_z);
    }
    const float pre_h = __fadd_rn(__fmul_rn(acc_h, scale), bias_h);
    const float pre_z = __fadd_rn(__fmul_rn(acc_z, scale), bias_z);
    // SAR-ADC transfer: mid-rise floor on the 63-unit capacitor grid
    const float v =
        fminf(fmaxf(__fadd_rn(__fdiv_rn(pre_z, 6.0f), 0.5f), 0.0f), 1.0f);
    const float z = __fdiv_rn(floorf(__fmul_rn(v, 63.0f)), 63.0f);
    // capacitor-swap update and comparator
    h = __fadd_rn(__fmul_rn(z, pre_h), __fmul_rn(__fsub_rn(1.0f, z), h));
    const int64_t o = (row * steps + t) * static_cast<int64_t>(N) + n;
    h_out[o] = h;
    y[o] = h > 0.0f ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int minimalist_block_f32(const void* x, const void* codes_h,
                                    const void* codes_z, float scale,
                                    const void* bh, const void* bz,
                                    const void* h0, void* y, void* h_out,
                                    int B, int steps, int K, int N,
                                    void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  minimalist_block_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes_h),
      static_cast<const int8_t*>(codes_z), scale,
      static_cast<const float*>(bh), static_cast<const float*>(bz),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), steps, K, N);
  return static_cast<int>(cudaGetLastError());
}
