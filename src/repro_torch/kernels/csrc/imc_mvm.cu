// The paper's switched-capacitor IMC projection (Eq. 6) as a tiled product:
// y[m, n] = (sum_k x[m, k] * (codes[k, n] - 1.5)) * scale[n] / K.
//
// Replaces the TPU kernel imc_mvm_pallas
// (src/repro/kernels/imc_mvm/imc_mvm.py:58, body _imc_kernel :35), whose
// grid (M/bm, N/bn, K/bk) carries an fp32 accumulator in VMEM scratch over
// the sequential K axis and applies the per-column scale and 1/K in the
// epilogue; its wrapper pads every axis to whole tiles and rescales by
// Kp/K.  Here one block of 256 threads owns a 64 x 64 output tile and
// walks K in steps of 16 in a loop: the x tile (fp32 {0,1}) and the codes
// tile (int8, turned into the levels c - 1.5 as they are staged) go to
// shared memory, and each thread accumulates a 4 x 4 register tile in
// fp32.  The ragged M, N and K edges are masked (a missing x entry or
// code adds an exact 0), so no padding and no Kp/K rescale: the epilogue
// multiplies by the column's scale and divides by the true K.
//
// Every term x * (c - 1.5) is a multiple of 0.5, so the fp32 sum is exact
// in any order while K * 1.5 < 2^24; the only rounding is the epilogue's.
//
// Bound: bytes at the skinny M of RNN inference (the codes are read once,
// as int8); at M 4096, K = N = 1024 x and y in fp32 (34.6 MB, 10.3 us)
// and the product's 8.6 GFLOP at the bf16 tensor-core rate (exact in
// bf16, 8.7 us) are close.  This first version runs the product on the
// fp32 CUDA cores from shared memory (no cp.async, no tensor cores), so it
// is bound by instruction throughput, far above either; a bf16 wgmma tile
// with the codes widened in registers is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace imc_mvm {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    imc_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int N) {
  __shared__ float xs[kBK][kBM + 1];   // x tile, transposed (padded row)
  __shared__ float ws[kBK][kBN];   // levels c - 1.5
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 16 x 16 threads, 4 x 4 each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i - mm * kBK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < K) ? x[static_cast<int64_t>(m) * K + k]
                                    : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, nn = i - kk * kBN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N)
          ? static_cast<float>(codes[static_cast<int64_t>(k) * N + n]) - 1.5f
          : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty * 4 + i];
        b[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float kf = static_cast<float>(K);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[static_cast<int64_t>(m) * N + n] = acc[i][j] * scale[n] / kf;
    }
  }
}

}  // namespace imc_mvm

extern "C" int imc_mvm_f32(const void* x, const void* codes,
                           const void* scale, void* out, int M, int K, int N,
                           void* stream) {
  const dim3 grid((N + imc_mvm::kBN - 1) / imc_mvm::kBN,
                  (M + imc_mvm::kBM - 1) / imc_mvm::kBM);
  imc_mvm::imc_kernel<<<grid, imc_mvm::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
