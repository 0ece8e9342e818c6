// Fused selective scan, forward: y and the chunk-entry states, without
// ever writing the (B, T, di, n) discretized terms or states to memory.
// Optionally from a given state h0 and with the state after the last step
// written out (h_last): the carry in and out of a serving prefill chunk.
//
// Replaces the TPU kernel fused_ssm_fwd
// (src/repro/kernels/fused_ssm/fused_ssm.py:113, _fwd_kernel at :32),
// whose grid walks (batch, d-block, time chunk) with the time chunks in
// order and the state carried in VMEM scratch.
//
// Design (layout in fused_ssm.cuh): one block per (d-block, batch row)
// walks all of T.  A lane keeps its channel's S states in registers, so
// the recurrence needs no memory at all: per step it forms u = dt * x
// once, then per state one ex2 and four FP32 ops (h = a h + u B, y += h C),
// and y is a register chain over the lane's states (plus one shuffle at
// two lanes a channel), stored straight to y (a warp's lanes on
// neighbouring channels: one 128-byte row segment).  Stages of kStage
// steps of dt, x, B and C arrive by cp.async in a kRing-slot ring, the
// next kRing - 1 stages in flight during a stage's walk; at every kChunk-th
// step the lane stores its states as the chunk's entry state (the
// backward's residual) in 16-byte stores.
//
// Bound: bytes at the main path's shape (B 4, T 2048, di 8192, n 16,
// fp32), as the reference's cost model counts them at 4 bytes an
// element: dt and x read, y written (B*T*di each), B and C read, the
// residual states written at the reference's 256-step spacing
// (B*T/256*di*n) -- 0.82 GB, 0.246 ms at 3.35 TB/s -- against 6 flops
// per (t, d, n) (6.4 GFLOP, 0.10 ms at the fp32 rate).  Beyond the bound
// the kernel writes a state every kChunk steps, 134 MB where the function
// needs 17 MB (0.04 ms).  Instructions, counted from the code, per
// (t, d, n): one ex2 and four FP32 ops (dt * A log2(e), u * B, the h and
// y FMAs), plus a sixteenth of a step's six (the dt and x loads, u, the y
// store) and four 16-byte B and C loads -- about 6 issue slots.  The ex2
// runs on the MUFU unit at 16 a cycle an SM: 1.07e9 of them at that
// shape are 0.29 ms on 132 SMs at 1.755 GHz, the 6 issue slots 0.22 ms
// on the 128 SMs its 128 blocks occupy, so the MUFU rate is this
// kernel's floor, a little above its byte bound.
#include "fused_ssm.cuh"

namespace ssm {

constexpr int kStage = 16;   // steps a ring slot (divides kChunk)
constexpr int kRing = 4;

template <int S, int NL, int CB>
__host__ __device__ constexpr int fwd_slot() {
  return kStage * (2 * CB + 2 * S * NL);
}
template <int S, int NL, int CB>
__host__ __device__ constexpr int fwd_smem() {
  return 4 * kRing * fwd_slot<S, NL, CB>();
}

template <int S, int NL, int CB>
__global__ void __launch_bounds__(CB * NL, 1)
    fwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_entries,
               float* __restrict__ h_last, int T, int di, int n, bool vec_d,
               bool vec_n) {
  constexpr int THREADS = CB * NL, NP = S * NL;
  extern __shared__ __align__(16) float smem[];
  const int c = threadIdx.x / NL, sub = threadIdx.x % NL;
  const int d0 = blockIdx.x * CB, d = d0 + c, b = blockIdx.y;
  const int s0 = sub * S;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int n_stages = (T + kStage - 1) / kStage;
  const int vcols = min(CB, di - d0);
  const bool store = sub == 0 && d < di;

  const int64_t state0 = (static_cast<int64_t>(b) * di + d) * n + s0;
  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool live = d < di && s0 + s < n;
    a2[s] = live ? A[static_cast<int64_t>(d) * n + s0 + s] * kLog2e : 0.0f;
    h[s] = (live && h0 != nullptr) ? h0[state0 + s] : 0.0f;
  }

  auto issue = [&](int i) {
    float* slot = smem + (i % kRing) * fwd_slot<S, NL, CB>();
    const int t0 = i * kStage;
    const int64_t row = static_cast<int64_t>(b) * T + t0;
    copy_tile<kStage, CB, THREADS>(slot, dt + row * di + d0, di, T - t0,
                                   vcols, vec_d);
    copy_tile<kStage, CB, THREADS>(slot + kStage * CB, x + row * di + d0,
                                   di, T - t0, vcols, vec_d);
    copy_tile<kStage, NP, THREADS>(slot + 2 * kStage * CB, Bm + row * n, n,
                                   T - t0, n, vec_n);
    copy_tile<kStage, NP, THREADS>(slot + 2 * kStage * CB + kStage * NP,
                                   Cm + row * n, n, T - t0, n, vec_n);
  };

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < n_stages) issue(i);
    cp_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_wait<kRing - 2>();
    __syncthreads();   // stage i landed; every lane is done with i - 1
    if (i + kRing - 1 < n_stages) issue(i + kRing - 1);
    cp_commit();

    const float* slot = smem + (i % kRing) * fwd_slot<S, NL, CB>();
    const float* s_dt = slot;
    const float* s_x = slot + kStage * CB;
    const float* s_B = slot + 2 * kStage * CB + s0;
    const float* s_C = s_B + kStage * NP;
    const int t0 = i * kStage, vrows = T - t0;
    if (t0 % kChunk == 0 && d < di)
      store_states<S>(h_entries +
                          ((static_cast<int64_t>(b) * n_chunks +
                            t0 / kChunk) * di + d) * n + s0,
                      h, n - s0, vec_n);
    float* y_row = y + (static_cast<int64_t>(b) * T + t0) * di + d;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const float dtv = s_dt[k * CB + c];
      const float u = dtv * s_x[k * CB + c];
      float bv[S], cv[S];
      load_row<S>(s_B + k * NP, bv);
      load_row<S>(s_C + k * NP, cv);
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = ex2(dtv * a2[s]) * h[s] + u * bv[s];
        acc += h[s] * cv[s];
      }
      if (NL == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (store && k < vrows) y_row[k * di] = acc;
    }
  }
  // the tail stage's steps past T run on zero-filled dt, so the state
  // is the one after step T - 1
  if (h_last != nullptr && d < di)
    store_states<S>(h_last + state0, h, n - s0, vec_n);
}

template <int S, int NL, int CB>
int launch_fwd(const float* dt, const float* x, const float* Bm,
               const float* Cm, const float* A, const float* h0, float* y,
               float* h_entries, float* h_last, int B, int T, int di, int n,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem<S, NL, CB>();
  const cudaError_t err = allow_smem<fwd_kernel<S, NL, CB>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_d = di % 4 == 0 && aligned16(dt) && aligned16(x);
  const bool vec_n = n % 4 == 0 && aligned16(Bm) && aligned16(Cm) &&
                     aligned16(h_entries) && aligned16(h_last);
  const dim3 grid((di + CB - 1) / CB, B);
  fwd_kernel<S, NL, CB><<<grid, CB * NL, smem, stream>>>(
      dt, x, Bm, Cm, A, h0, y, h_entries, h_last, T, di, n, vec_d, vec_n);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int NL, int CB>
int info_fwd(int* out) {
  return kernel_info<fwd_kernel<S, NL, CB>>(CB * NL, CB,
                                            fwd_smem<S, NL, CB>(), out);
}

}  // namespace ssm

// chunk must be ssm::kChunk (the caller sizes h_entries with it) and
// 1 <= n <= 32; anything else returns cudaErrorInvalidValue unlaunched.
// h0 (B, di, n) may be null (a zero state); h_last (B, di, n) may be null
// (not written).
extern "C" int fused_ssm_fwd_f32(const void* dt, const void* x,
                                 const void* Bm, const void* Cm,
                                 const void* A, const void* h0, void* y,
                                 void* h_entries, void* h_last, int B, int T,
                                 int di, int n, int chunk, void* stream) {
  if (chunk != ssm::kChunk) return static_cast<int>(cudaErrorInvalidValue);
  SSM_DISPATCH(n, ssm::launch_fwd, static_cast<const float*>(dt),
               static_cast<const float*>(x), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(A),
               static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(h_entries), static_cast<float*>(h_last), B,
               T, di, n, static_cast<cudaStream_t>(stream))
}

// The build's registers, local bytes, shared bytes, resident blocks an SM,
// threads and channels a block at state size n (ssm::kernel_info).
extern "C" int fused_ssm_fwd_info(int n, void* out) {
  SSM_DISPATCH(n, ssm::info_fwd, static_cast<int*>(out))
}
