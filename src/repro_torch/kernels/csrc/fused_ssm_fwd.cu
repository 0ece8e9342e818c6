// Fused selective scan, forward: y and the chunk-entry states, without
// ever writing the (B, T, di, n) discretized terms or states to memory.
//
// Replaces the TPU kernel fused_ssm_fwd
// (src/repro/kernels/fused_ssm/fused_ssm.py:113, _fwd_kernel at :32),
// whose grid walks (batch, d-block, time chunk) with the time chunks in
// order and the state carried in VMEM scratch.
//
// Design (layout in fused_ssm.cuh): one block per (d-block, batch row)
// walks all of T; each thread keeps the state h of its (d, n) pair in a
// register, so the recurrence needs no memory at all.  Per chunk of
// kChunk steps the block stores its states as the chunk's entry state
// (the backward's residual), stages dt, x, B and C, runs the steps, sums
// h * C over the n lanes of each d with xor-shuffles and keeps y in
// shared memory, then writes the chunk's y rows coalesced.
//
// Bound: bytes at the main path's shape (B 4, T 2048, di 8192, n 16,
// fp32), as the reference's cost model counts them at 4 bytes an
// element: dt and x read, y written (B*T*di each), B and C read, the
// residual states written at the reference's 256-step spacing
// (B*T/256*di*n) -- 0.82 GB, 0.246 ms at 3.35 TB/s -- against 6 flops
// per (t, d, n) (6.4 GFLOP, 0.10 ms at the fp32 rate).  This kernel
// writes a state every kChunk steps instead, 134 MB where the function
// needs 17 MB: a cost of its design, kept out of the bound.  The accurate expf alone
// is ~15 instructions, so the real floor is the instruction rate: ~25
// instructions per (t, d, n), about 0.9 ms on 132 SMs at the full
// instruction rate.
#include "fused_ssm.cuh"

namespace ssm {

template <int NL>
constexpr int fwd_smem() {
  return 4 * (3 * kChunk * (kThreads / NL) + 2 * kChunk * NL);
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A, float* __restrict__ y,
               float* __restrict__ h_entries, int T, int di, int n) {
  constexpr int DB = kThreads / NL;
  extern __shared__ float smem[];
  float* s_dt = smem;                  // [kChunk][DB]
  float* s_x = s_dt + kChunk * DB;     // [kChunk][DB]
  float* s_y = s_x + kChunk * DB;      // [kChunk][DB]
  float* s_B = s_y + kChunk * DB;      // [kChunk][NL]
  float* s_C = s_B + kChunk * NL;      // [kChunk][NL]

  const int ln = threadIdx.x % NL, dl = threadIdx.x / NL;
  const int d0 = blockIdx.x * DB, d = d0 + dl, b = blockIdx.y;
  const bool act = ln < n && d < di;
  const float a_dn = act ? A[static_cast<int64_t>(d) * n + ln] : 0.0f;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  float h = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, len = min(kChunk, T - t0);
    const int64_t row0 = static_cast<int64_t>(b) * T + t0;
    if (act)
      h_entries[((static_cast<int64_t>(b) * n_chunks + c) * di + d) * n +
                ln] = h;
    // the previous chunk's steps have read these buffers: its closing
    // barrier came after them
    stage<DB>(dt, row0, di, d0, len, s_dt);
    stage<DB>(x, row0, di, d0, len, s_x);
    stage<NL>(Bm, row0, n, 0, len, s_B);
    stage<NL>(Cm, row0, n, 0, len, s_C);
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float dtv = s_dt[tt * DB + dl];
      const float a = expf(__fmul_rn(dtv, a_dn));
      const float u = __fmul_rn(dtv, s_x[tt * DB + dl]);
      h = __fadd_rn(__fmul_rn(a, h), __fmul_rn(u, s_B[tt * NL + ln]));
      const float p = lane_sum<1, NL>(__fmul_rn(h, s_C[tt * NL + ln]));
      if (ln == 0) s_y[tt * DB + dl] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * DB; i += kThreads) {
      const int tt = i / DB, col = d0 + i - tt * DB;
      if (tt < len && col < di) y[(row0 + tt) * di + col] = s_y[i];
    }
  }
}

template <int NL>
int launch_fwd(const float* dt, const float* x, const float* Bm,
               const float* Cm, const float* A, float* y, float* h_entries,
               int B, int T, int di, int n, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr int smem = fwd_smem<NL>();
  const cudaError_t err = allow_smem(fwd_kernel<NL>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + kThreads / NL - 1) / (kThreads / NL), B);
  fwd_kernel<NL><<<grid, kThreads, smem, stream>>>(dt, x, Bm, Cm, A, y,
                                                   h_entries, T, di, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssm

// chunk must be ssm::kChunk (the caller sizes h_entries with it) and
// 1 <= n <= 32; anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int fused_ssm_fwd_f32(const void* dt, const void* x,
                                 const void* Bm, const void* Cm,
                                 const void* A, void* y, void* h_entries,
                                 int B, int T, int di, int n, int chunk,
                                 void* stream) {
  if (chunk != ssm::kChunk) return static_cast<int>(cudaErrorInvalidValue);
  SSM_DISPATCH_LANES(ssm::lanes_for(n), ssm::launch_fwd,
                     static_cast<const float*>(dt),
                     static_cast<const float*>(x),
                     static_cast<const float*>(Bm),
                     static_cast<const float*>(Cm),
                     static_cast<const float*>(A), static_cast<float*>(y),
                     static_cast<float*>(h_entries), B, T, di, n,
                     static_cast<cudaStream_t>(stream))
}
