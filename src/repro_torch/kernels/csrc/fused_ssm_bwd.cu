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
// walks the chunks last to first, each in sub-chunks of kSub steps.  A
// lane keeps its channel's S states, the carry lam = dh_{t+1} a_{t+1} and
// the dA sums in registers.  Per chunk it walks forward from the saved
// entry state through all but the last sub-chunk, leaving each
// sub-chunk's start state in shared memory (its own column); then, last
// sub-chunk to first, it recomputes the sub-chunk's kSub states into
// registers (kSub x S of them, the walk unrolled at compile time) and
// walks it backwards:
//
//   dh    = dy_t C_t + lam                  da = dh h_{t-1}
//   ddt_t = sum_n da A a_t + x_t sum_n dh B_t
//   dx_t  = dt_t sum_n dh B_t
//   dB_t  = sum_d dh dt_t x_t               dC_t = sum_d dy_t h_t
//   dA   += da dt_t a_t                     lam = dh a_t
//
// The sums over n are register adds (plus one shuffle at two lanes a
// channel).  The sums over d of dB (in the reverse walk) and dC (in the
// recompute) go, a step at a time, through a per-warp [n][channel]
// tile: each lane writes its S values, reads back a few channels of one
// state as 16-byte loads and adds, and the lanes of a state meet by
// xor-shuffles; the warp's sums land in a [step][warp][n] buffer that
// the block adds over its warps at the next stage, in a fixed order, and
// writes as one partial row a block: dBp, dCp (B, P, T, n) with P =
// ceil(di / CB), the block's 256 (at n > 16: 128) channels summed on chip.
// dA stays in registers over the whole walk and is written once per
// (batch, d, n) as dAp (B, di, n).  The wrapper adds the P partial rows
// and the B dA rows (kernels/fused_ssm/ops.py).  The sub-chunks' inputs
// arrive in a cp.async ring with the chunk's entry states, later stages
// in flight during a stage's walk.
//
// Bound: bytes at the main path's shape (B 4, T 2048, di 8192, n 16,
// fp32), the reference's cost model at 4 bytes an element (training
// less forward): dt, x, dy read and ddt, dx written (B*T*di each), B, C
// read and dB, dC written, the residual states read at the reference's
// 256-step spacing -- 1.36 GB, 0.406 ms at 3.35 TB/s -- against its 15
// flops per (t, d, n) (16.1 GFLOP, 0.24 ms).  Beyond the bound this
// design moves the kChunk-step entry states (134 MB read), the dB/dC
// partials (34 MB written, then read by the wrapper's sums: 0.02 ms) and,
// from L2, the forward walk's second read of dt, x and B.  Instructions,
// counted from the code, per (t, d, n): 0.75 forward-walk steps (ex2 and
// 3 FP32 ops), the recompute (ex2, 4 FP32 ops, the dC product's store to
// the tile and its share of the tile sum, ~1.5) and the reverse step
// (ex2, 9 FP32 ops, the dB store and tile-sum share) with the loads --
// about 24 issue slots and 2.75 ex2.  On the MUFU unit (16 ex2 a cycle an
// SM) that is 0.79 ms on 132 SMs at 1.755 GHz, the issue slots 0.89 ms on
// the 128 SMs its 128 blocks occupy: the instruction rate, not the bytes,
// sets this kernel's floor, about twice its byte bound.
#include "fused_ssm.cuh"

namespace ssm {

constexpr int kSub = 8;                  // steps a stage
constexpr int kSubs = kChunk / kSub;     // sub-chunks of a full chunk

template <int S, int NL, int CB>
struct BwdLayout {
  static constexpr int THREADS = CB * NL, W = THREADS / 32, NP = S * NL;
  static constexpr int CW = 32 / NL;          // channels a warp
  static constexpr int TS = CW + 4;           // tile row stride
  static constexpr int SLOT = kSub * (3 * CB + 2 * NP);
  static constexpr int HBUF = CB * NP;        // one chunk's entry states
  static constexpr int BND = (kSubs - 1) * S * THREADS;
  static constexpr int TILE = 2 * NP * TS;    // a warp's two tiles
  static constexpr int RED = 2 * kSub * W * NP;  // [dB|dC][step][warp][n]
  static constexpr int FIXED = 2 * HBUF + BND + W * TILE + 2 * RED;
  static constexpr int RING = 4 * (3 * SLOT + FIXED) <= 227 * 1024 ? 3 : 2;
  static constexpr int BYTES = 4 * (RING * SLOT + FIXED);
};

template <int S, int NL, int CB>
__global__ void __launch_bounds__(CB * NL, 1)
    bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A,
               const float* __restrict__ h_entries,
               const float* __restrict__ dy, float* __restrict__ ddt,
               float* __restrict__ dx, float* __restrict__ dBp,
               float* __restrict__ dCp, float* __restrict__ dAp, int T,
               int di, int n, bool vec_d, bool vec_n) {
  using L = BwdLayout<S, NL, CB>;
  constexpr int THREADS = L::THREADS, W = L::W, NP = L::NP, TS = L::TS;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* hbuf = ring + L::RING * L::SLOT;   // [chunk & 1][CB][NP]
  float* bnd = hbuf + 2 * L::HBUF;          // [sub-chunk - 1][S][THREADS]
  float* tile = bnd + L::BND;               // [warp][2][NP][TS]
  float* red = tile + W * L::TILE;          // [stage & 1][RED]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x / NL, sub = threadIdx.x % NL, s0 = sub * S;
  const int d0 = blockIdx.x * CB, d = d0 + c, b = blockIdx.y;
  const int P = gridDim.x, vcols = min(CB, di - d0);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int ns_last = (T - (n_chunks - 1) * kChunk + kSub - 1) / kSub;
  const int m0 = 2 * ns_last - 1;
  const int n_stages = m0 + (n_chunks - 1) * (2 * kSubs - 1);

  float a2[S], lam[S], dA[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a2[s] = (d < di && s0 + s < n)
                ? A[static_cast<int64_t>(d) * n + s0 + s] * kLog2e
                : 0.0f;
    lam[s] = 0.0f;
    dA[s] = 0.0f;
  }

  // Stage i -> (chunk, sub-chunk, forward-only?, first of its chunk?):
  // per chunk (last to first) the forward stages of sub-chunks 0 ..
  // ns - 2, then the reverse stages of ns - 1 .. 0.
  struct Stage {
    int chunk, s, t0;
    bool fwd, first;
  };
  auto stage_at = [&](int i) {
    Stage st;
    int j, ns;
    if (i < m0) {
      st.chunk = n_chunks - 1;
      j = i;
      ns = ns_last;
    } else {
      const int q = (i - m0) / (2 * kSubs - 1);
      st.chunk = n_chunks - 2 - q;
      j = i - m0 - q * (2 * kSubs - 1);
      ns = kSubs;
    }
    st.fwd = j < ns - 1;
    st.s = st.fwd ? j : 2 * (ns - 1) - j;
    st.first = j == 0;
    st.t0 = st.chunk * kChunk + st.s * kSub;
    return st;
  };

  auto issue = [&](int i) {
    const Stage st = stage_at(i);
    float* slot = ring + (i % L::RING) * L::SLOT;
    const int64_t row = static_cast<int64_t>(b) * T + st.t0;
    const int vrows = T - st.t0;
    copy_tile<kSub, CB, THREADS>(slot, dt + row * di + d0, di, vrows, vcols,
                                 vec_d);
    copy_tile<kSub, CB, THREADS>(slot + kSub * CB, x + row * di + d0, di,
                                 vrows, vcols, vec_d);
    copy_tile<kSub, NP, THREADS>(slot + 3 * kSub * CB, Bm + row * n, n,
                                 vrows, n, vec_n);
    if (!st.fwd) {
      copy_tile<kSub, CB, THREADS>(slot + 2 * kSub * CB, dy + row * di + d0,
                                   di, vrows, vcols, vec_d);
      copy_tile<kSub, NP, THREADS>(slot + 3 * kSub * CB + kSub * NP,
                                   Cm + row * n, n, vrows, n, vec_n);
    }
    if (st.first)
      copy_tile<CB, NP, THREADS>(
          hbuf + (st.chunk & 1) * L::HBUF,
          h_entries + ((static_cast<int64_t>(b) * n_chunks + st.chunk) * di +
                       d0) * n,
          n, vcols, n, vec_n);
  };

  // The block's sums over its warps of reverse stage st's dB and dC rows,
  // left in red[par].
  auto flush = [&](const Stage& st, int par) {
    if (st.fwd) return;
    const float* r = red + par * L::RED;
    for (int o = threadIdx.x; o < 2 * kSub * NP; o += THREADS) {
      const int kind = o / (kSub * NP), k = (o / NP) % kSub, v = o % NP;
      if (v < n && st.t0 + k < T) {
        const float* q = r + (kind * kSub + k) * W * NP + v;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < W; ++w) sum += q[w * NP];
        (kind ? dCp : dBp)[((static_cast<int64_t>(b) * P + blockIdx.x) * T +
                            st.t0 + k) * n + v] = sum;
      }
    }
  };

  // One step's sum over the warp's channels of the S values each lane
  // put in tile `tl`, written as the warp's row of `rd`.
  constexpr int G = 32 / NP;             // lanes a state
  constexpr int CPG = L::CW / G;         // channels a lane adds
  auto warp_sum = [&](const float* tl, float* rd) {
    __syncwarp();
    const int vi = lane % NP, g = lane / NP;
    const float* p = tl + vi * TS + g * CPG;
    float sum = 0.0f;
    if (CPG % 4 == 0) {
#pragma unroll
      for (int j = 0; j < CPG; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + j);
        sum += (q.x + q.y) + (q.z + q.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPG; ++j) sum += p[j];
    }
#pragma unroll
    for (int o = NP; o < 32; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < NP) rd[warp * NP + lane] = sum;
  };

#pragma unroll
  for (int i = 0; i < L::RING - 1; ++i) {
    if (i < n_stages) issue(i);
    cp_commit();
  }
  float* w_tile = tile + warp * L::TILE;             // this warp's tiles
  float* my_tile = w_tile + s0 * TS + lane / NL;       // this lane's column
  const bool store = sub == 0 && d < di;
  Stage prev{};
  for (int i = 0; i < n_stages; ++i) {
    cp_wait<L::RING - 2>();
    __syncthreads();   // stage i landed; every lane is done with i - 1
    if (i + L::RING - 1 < n_stages) issue(i + L::RING - 1);
    cp_commit();
    if (i > 0) flush(prev, (i - 1) & 1);

    const Stage st = stage_at(i);
    prev = st;
    const float* slot = ring + (i % L::RING) * L::SLOT;
    const float* s_dt = slot;
    const float* s_x = slot + kSub * CB;
    const float* s_dy = slot + 2 * kSub * CB;
    const float* s_B = slot + 3 * kSub * CB + s0;
    const float* s_C = s_B + kSub * NP;
    float* r = red + (i & 1) * L::RED;

    float h[S];
    if (st.s == 0) {
      load_row<S>(hbuf + (st.chunk & 1) * L::HBUF + c * NP + s0, h);
    } else {
      const float* bs = bnd + (st.s - 1) * S * THREADS + threadIdx.x;
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = bs[s * THREADS];
    }

    if (st.fwd) {
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const float dtv = s_dt[k * CB + c];
        const float u = dtv * s_x[k * CB + c];
        float bv[S];
        load_row<S>(s_B + k * NP, bv);
#pragma unroll
        for (int s = 0; s < S; ++s)
          h[s] = ex2(dtv * a2[s]) * h[s] + u * bv[s];
      }
      float* bs = bnd + st.s * S * THREADS + threadIdx.x;
#pragma unroll
      for (int s = 0; s < S; ++s) bs[s * THREADS] = h[s];
      continue;
    }

    // recompute: hk[k] = h_{t0 + k - 1}; dC's rows on the way
    float hk[kSub][S];
#pragma unroll
    for (int s = 0; s < S; ++s) hk[0][s] = h[s];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const float dtv = s_dt[k * CB + c];
      const float u = dtv * s_x[k * CB + c];
      const float dyv = s_dy[k * CB + c];
      float bv[S];
      load_row<S>(s_B + k * NP, bv);
      float* tl = my_tile + (k & 1) * NP * TS;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float hn = ex2(dtv * a2[s]) * hk[k][s] + u * bv[s];
        if (k + 1 < kSub) hk[k + 1][s] = hn;
        tl[s * TS] = dyv * hn;
      }
      warp_sum(w_tile + (k & 1) * NP * TS, r + (kSub + k) * W * NP);
    }

    // the reverse walk
    const int vrows = T - st.t0;
    float* ddt_row = ddt + (static_cast<int64_t>(b) * T + st.t0) * di + d;
    float* dx_row = dx + (static_cast<int64_t>(b) * T + st.t0) * di + d;
#pragma unroll
    for (int k = kSub - 1; k >= 0; --k) {
      const float dtv = s_dt[k * CB + c], xv = s_x[k * CB + c];
      const float dyv = s_dy[k * CB + c];
      const float u = dtv * xv;
      float bv[S], cv[S];
      load_row<S>(s_B + k * NP, bv);
      load_row<S>(s_C + k * NP, cv);
      float* tl = my_tile + ((k & 1) ^ 1) * NP * TS;
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float dh = dyv * cv[s] + lam[s];
        lam[s] = dh * ex2(dtv * a2[s]);        // the carry into step t - 1
        const float q = lam[s] * hk[k][s];     // da a = dh h_{t-1} a
        sa += q * a2[s];
        dA[s] += q * dtv;
        sb += dh * bv[s];
        tl[s * TS] = dh * u;
      }
      if (NL == 2) {
        sa += __shfl_xor_sync(0xffffffffu, sa, 1);
        sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      }
      if (store && k < vrows) {
        ddt_row[k * di] = sa * kLn2 + sb * xv;
        dx_row[k * di] = dtv * sb;
      }
      warp_sum(w_tile + ((k & 1) ^ 1) * NP * TS, r + k * W * NP);
    }
  }
  __syncthreads();
  flush(prev, (n_stages - 1) & 1);
  if (d < di)
    store_states<S>(dAp + (static_cast<int64_t>(b) * di + d) * n + s0, dA,
                    n - s0, vec_n);
}

template <int S, int NL, int CB>
int launch_bwd(const float* dt, const float* x, const float* Bm,
               const float* Cm, const float* A, const float* h_entries,
               const float* dy, float* ddt, float* dx, float* dBp,
               float* dCp, float* dAp, int B, int T, int di, int n,
               int n_rows, cudaStream_t stream) {
  if (n_rows != (di + CB - 1) / CB)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = BwdLayout<S, NL, CB>::BYTES;
  const cudaError_t err = allow_smem<bwd_kernel<S, NL, CB>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_d = di % 4 == 0 && aligned16(dt) && aligned16(x) &&
                     aligned16(dy);
  const bool vec_n = n % 4 == 0 && aligned16(Bm) && aligned16(Cm) &&
                     aligned16(h_entries) && aligned16(dAp);
  const dim3 grid(n_rows, B);
  bwd_kernel<S, NL, CB><<<grid, CB * NL, smem, stream>>>(
      dt, x, Bm, Cm, A, h_entries, dy, ddt, dx, dBp, dCp, dAp, T, di, n,
      vec_d, vec_n);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int NL, int CB>
int info_bwd(int* out) {
  return kernel_info<bwd_kernel<S, NL, CB>>(CB * NL, CB,
                                            BwdLayout<S, NL, CB>::BYTES, out);
}

}  // namespace ssm

// chunk must be ssm::kChunk, 1 <= n <= 32 and n_rows the number of
// partial rows, ceil(di / CB) (CB = ssm::config_for(n).CB), that sizes
// dBp and dCp; anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int fused_ssm_bwd_f32(const void* dt, const void* x,
                                 const void* Bm, const void* Cm,
                                 const void* A, const void* h_entries,
                                 const void* dy, void* ddt, void* dx,
                                 void* dBp, void* dCp, void* dAp, int B,
                                 int T, int di, int n, int chunk, int n_rows,
                                 void* stream) {
  if (chunk != ssm::kChunk) return static_cast<int>(cudaErrorInvalidValue);
  SSM_DISPATCH(
      n, ssm::launch_bwd, static_cast<const float*>(dt),
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(A),
      static_cast<const float*>(h_entries), static_cast<const float*>(dy),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), B, T, di, n, n_rows,
      static_cast<cudaStream_t>(stream))
}

// As fused_ssm_fwd_info, for the backward kernel.
extern "C" int fused_ssm_bwd_info(int n, void* out) {
  SSM_DISPATCH(n, ssm::info_bwd, static_cast<int*>(out))
}
