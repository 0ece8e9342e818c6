// Fused selective scan, backward: ddt and dx, and partial sums of dB, dC
// and dA, from the forward's inputs, its chunk-entry states and dy,
// without writing any (B, T, di, n) tensor to memory.
//
// Replaces the TPU kernel fused_ssm_bwd
// (src/repro/kernels/fused_ssm/fused_ssm.py:147, _bwd_kernel at :59),
// whose grid walks the time chunks in reverse, recomputes each chunk's
// trajectory from its entry state in VMEM and runs the reverse
// recurrence with all gradients formed on the fly.
//
// Design (layout in fused_ssm.cuh): one block per (d-block, batch row)
// walks the chunks last to first.  Per chunk it stages dt, x, dy, B and
// C, recomputes the chunk's states from the saved entry state into a
// [kChunk][kThreads] trajectory in shared memory (each thread reads back
// only its own column, so no barrier sits between the two walks), then
// walks the chunk backwards with the carry lam = dh_{t+1} * a_{t+1} in a
// register:
//
//   dh    = dy_t C_t + lam                  da = dh h_{t-1}
//   ddt_t = sum_n da A a_t + x_t sum_n dh B_t
//   dx_t  = dt_t sum_n dh B_t
//   dB_t  = sum_d dh dt_t x_t               dC_t = sum_d dy_t h_t
//   dA   += da dt_t a_t                     lam = dh a_t
//
// The sums over n are xor-shuffles across the NL lanes of a d.  The sums
// over d of dB and dC go by xor-shuffles across the d's of a warp into a
// [kChunk][kWarps][NL] buffer, which the block adds over its warps once a
// chunk and writes as per-(batch, d-block) partials dBp, dCp (B, n_dblk,
// T, n); dA stays in a register over the whole walk and is written once
// per (batch, d, n) as dAp (B, di, n).  The wrapper sums the partials
// (kernels/fused_ssm/ops.py), as the reference's custom VJP does.  At
// n = 16 a block holds 78 KB of shared memory, two blocks an SM.
//
// Bound: bytes at the main path's shape (B 4, T 2048, di 8192, n 16,
// fp32), the reference's cost model at 4 bytes an element (training
// less forward): dt, x, dy read and ddt, dx written (B*T*di each), B, C
// read and dB, dC written, the residual states read at the reference's
// 256-step spacing -- 1.36 GB, 0.406 ms at 3.35 TB/s -- against its 15
// flops per (t, d, n) (16.1 GFLOP, 0.24 ms).  The kChunk-step entry
// states (134 MB) and the dB/dC partials (1.07 GB written, then read by
// the wrapper's sums) are costs of this design, kept out of the bound.  Two accurate expf and ten shuffles per
// (t, d, n) make the instruction rate the real floor, several times
// that.
#include "fused_ssm.cuh"

namespace ssm {

template <int NL>
constexpr int bwd_smem() {
  return 4 * (5 * kChunk * (kThreads / NL) + 2 * kChunk * NL +
              kChunk * kThreads + 2 * kChunk * kWarps * NL);
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A,
               const float* __restrict__ h_entries,
               const float* __restrict__ dy, float* __restrict__ ddt,
               float* __restrict__ dx, float* __restrict__ dBp,
               float* __restrict__ dCp, float* __restrict__ dAp, int T,
               int di, int n) {
  constexpr int DB = kThreads / NL;
  extern __shared__ float smem[];
  float* s_dt = smem;                      // [kChunk][DB]
  float* s_x = s_dt + kChunk * DB;         // [kChunk][DB]
  float* s_dy = s_x + kChunk * DB;         // [kChunk][DB]
  float* s_ddt = s_dy + kChunk * DB;       // [kChunk][DB]
  float* s_dx = s_ddt + kChunk * DB;       // [kChunk][DB]
  float* s_B = s_dx + kChunk * DB;         // [kChunk][NL]
  float* s_C = s_B + kChunk * NL;          // [kChunk][NL]
  float* traj = s_C + kChunk * NL;         // [kChunk][kThreads]
  float* r_B = traj + kChunk * kThreads;   // [kChunk][kWarps][NL]
  float* r_C = r_B + kChunk * kWarps * NL; // [kChunk][kWarps][NL]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ln = threadIdx.x % NL, dl = threadIdx.x / NL;
  const int d0 = blockIdx.x * DB, d = d0 + dl, b = blockIdx.y;
  const int n_dblk = gridDim.x;
  const bool act = ln < n && d < di;
  const float a_dn = act ? A[static_cast<int64_t>(d) * n + ln] : 0.0f;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  float lam = 0.0f, dA = 0.0f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, T - t0);
    const int64_t row0 = static_cast<int64_t>(b) * T + t0;
    const float h_entry =
        act ? h_entries[((static_cast<int64_t>(b) * n_chunks + c) * di + d) *
                            n + ln]
            : 0.0f;
    // nothing reads the staged inputs after the last chunk's walks: the
    // barrier after them came first
    stage<DB>(dt, row0, di, d0, len, s_dt);
    stage<DB>(x, row0, di, d0, len, s_x);
    stage<DB>(dy, row0, di, d0, len, s_dy);
    stage<NL>(Bm, row0, n, 0, len, s_B);
    stage<NL>(Cm, row0, n, 0, len, s_C);
    __syncthreads();

    // (1) the chunk's states from its entry state
    float h = h_entry;
    for (int tt = 0; tt < len; ++tt) {
      const float dtv = s_dt[tt * DB + dl];
      const float a = expf(__fmul_rn(dtv, a_dn));
      const float u = __fmul_rn(dtv, s_x[tt * DB + dl]);
      h = __fadd_rn(__fmul_rn(a, h), __fmul_rn(u, s_B[tt * NL + ln]));
      traj[tt * kThreads + threadIdx.x] = h;
    }

    // (2) the reverse walk
    for (int tt = len - 1; tt >= 0; --tt) {
      const float dtv = s_dt[tt * DB + dl], xv = s_x[tt * DB + dl];
      const float dyv = s_dy[tt * DB + dl];
      const float a = expf(__fmul_rn(dtv, a_dn));
      const float h_t = traj[tt * kThreads + threadIdx.x];
      const float h_prev =
          tt ? traj[(tt - 1) * kThreads + threadIdx.x] : h_entry;
      const float dh = __fadd_rn(__fmul_rn(dyv, s_C[tt * NL + ln]), lam);
      const float da = __fmul_rn(dh, h_prev);
      const float s_a = lane_sum<1, NL>(__fmul_rn(__fmul_rn(da, a_dn), a));
      const float s_b = lane_sum<1, NL>(__fmul_rn(dh, s_B[tt * NL + ln]));
      const float c_b = lane_sum<NL, 32>(__fmul_rn(dh, __fmul_rn(dtv, xv)));
      const float c_c = lane_sum<NL, 32>(__fmul_rn(dyv, h_t));
      dA = __fadd_rn(dA, __fmul_rn(__fmul_rn(da, dtv), a));
      lam = __fmul_rn(dh, a);
      if (ln == 0) {
        s_ddt[tt * DB + dl] = __fadd_rn(s_a, __fmul_rn(s_b, xv));
        s_dx[tt * DB + dl] = __fmul_rn(dtv, s_b);
      }
      if (lane < NL) {
        r_B[(tt * kWarps + warp) * NL + lane] = c_b;
        r_C[(tt * kWarps + warp) * NL + lane] = c_c;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kChunk * DB; i += kThreads) {
      const int tt = i / DB, col = d0 + i - tt * DB;
      if (tt < len && col < di) {
        ddt[(row0 + tt) * di + col] = s_ddt[i];
        dx[(row0 + tt) * di + col] = s_dx[i];
      }
    }
    const int64_t prow0 =
        (static_cast<int64_t>(b) * n_dblk + blockIdx.x) * T + t0;
    for (int i = threadIdx.x; i < kChunk * NL; i += kThreads) {
      const int tt = i / NL, j = i - tt * NL;
      if (tt < len && j < n) {
        float sb = 0.0f, sc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb = __fadd_rn(sb, r_B[(tt * kWarps + w) * NL + j]);
          sc = __fadd_rn(sc, r_C[(tt * kWarps + w) * NL + j]);
        }
        dBp[(prow0 + tt) * n + j] = sb;
        dCp[(prow0 + tt) * n + j] = sc;
      }
    }
  }
  if (act) dAp[(static_cast<int64_t>(b) * di + d) * n + ln] = dA;
}

template <int NL>
int launch_bwd(const float* dt, const float* x, const float* Bm,
               const float* Cm, const float* A, const float* h_entries,
               const float* dy, float* ddt, float* dx, float* dBp,
               float* dCp, float* dAp, int B, int T, int di, int n,
               int n_dblk, cudaStream_t stream) {
  if (n_dblk != (di + kThreads / NL - 1) / (kThreads / NL))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  constexpr int smem = bwd_smem<NL>();
  const cudaError_t err = allow_smem(bwd_kernel<NL>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_dblk, B);
  bwd_kernel<NL><<<grid, kThreads, smem, stream>>>(
      dt, x, Bm, Cm, A, h_entries, dy, ddt, dx, dBp, dCp, dAp, T, di, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssm

// chunk must be ssm::kChunk, 1 <= n <= 32 and n_dblk the number of
// d-blocks, ceil(di / (kThreads / lanes_for(n))), that sizes dBp and dCp;
// anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int fused_ssm_bwd_f32(const void* dt, const void* x,
                                 const void* Bm, const void* Cm,
                                 const void* A, const void* h_entries,
                                 const void* dy, void* ddt, void* dx,
                                 void* dBp, void* dCp, void* dAp, int B,
                                 int T, int di, int n, int chunk, int n_dblk,
                                 void* stream) {
  if (chunk != ssm::kChunk) return static_cast<int>(cudaErrorInvalidValue);
  SSM_DISPATCH_LANES(
      ssm::lanes_for(n), ssm::launch_bwd, static_cast<const float*>(dt),
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(A),
      static_cast<const float*>(h_entries), static_cast<const float*>(dy),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), B, T, di, n, n_dblk,
      static_cast<cudaStream_t>(stream))
}
