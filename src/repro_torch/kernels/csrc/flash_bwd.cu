// FlashAttention-2 backward: a dQ kernel and a dK/dV kernel, both
// recomputing p = exp(s - lse) from the forward's row logsumexp, on the
// tensor cores (tc route) or the CUDA cores (simt route).
//
// Replaces the TPU kernel flash_bwd
// (src/repro/kernels/flash_attention/flash_attention.py:232): its
// _dkv_kernel (pallas_call at :241) and _dq_kernel (:270), the delta =
// rowsum(o * do) it computes in XLA (:237), and the sum over each kv
// head's group of query heads that its custom VJP does afterwards
// (ops.py:70-71).
//
//   * dq kernel: one block per (batch, head, query tile).  Its prologue
//     computes delta for the tile's rows from out and do and writes it to
//     global memory for the dK/dV kernel; then it loops over the KV tiles
//     the rows can see (kv_tiles), recomputes s and p, forms dp = do.v
//     and ds = p * (dp - delta) * scale and accumulates dq += ds @ K.
//   * dkv kernel: one block per (batch, kv head, KV tile).  It loops over
//     the G query heads of the kv head and, for each, over the query
//     tiles that can see the KV tile (q_tiles), and accumulates dv +=
//     p^T @ do and dk += ds^T @ q.  The group sum of dk and dv is so taken
//     inside the block: no atomics and no (B, H, S, D) per-query-head
//     intermediates, and two calls give bitwise the same gradients.
//
// The dq kernel runs first (the dkv kernel reads its delta).  Masks,
// tile skipping and the -1e30 convention are the forward's
// (flash_attention.cuh); a masked entry has p = exp(-1e30 - lse) = 0 and
// adds exactly zero, and query rows past S are given p = 0.
//
// Bound: operations.  About 2.5x the forward's flops (s and dp, then dq,
// dk and dv: five products of the forward's size, against its two).
//
// Two routes, chosen by the wrapper (ops.route):
//   * tc (bf16 at D 16/32/64/128 and 129-256, flash_bwd_{dq,dkv}_bf16_tc):
//     one warpgroup a tile of 64 query rows (dq) or 64 keys (dkv), the
//     block's own tiles loaded once by TMA and the others streaming
//     through a two-stage TMA/mbarrier ring; s, dp (dkv: s^T, dp^T) on
//     wgmma from shared memory, ds and p split into three bf16 parts as
//     the A operand of dq += ds.K, dv += p^T.do and dk += ds^T.q, each
//     tile's product added to the fp32 sums in registers (flash_tc.cuh).
//     Above D 128 (run at 160 or 256) the products run a 64-column panel
//     at a time; from D 128 the dkv kernel is two warpgroups, one summing
//     dV and one dK (dkv_wide_tc_kernel); shared memory of dq at D 256: q
//     and do 64 KB + 2 stages x (K + V) 128 KB.
//   * simt (fp32, and bf16 at the other head dims below 128:
//     flash_bwd_{dq,dkv}_{f32,bf16}; a head dim is run at the next
//     compiled one, flash_attention.cuh): the first version, on the CUDA
//     cores with p and ds staged in shared memory as fp32, bound by
//     shared-memory loads.
#include "flash_attention.cuh"
#include "flash_tc.cuh"

namespace flash {

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;
  float* delta;
  T* dq;
  T* dk;
  T* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, KV, S, causal, window;
  int dim;  // the true head dim, <= D
  float scale;
};

template <int D, int BQ, int BK>
constexpr int dq_smem() {
  return 4 * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D, int BQ, int BK>
constexpr int dkv_smem() {
  return 4 * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + 2 * BQ * (BK + 1) +
              2 * BQ);
}

// s = q.k * scale + mask and dp = do.v for the (BQ x BK) tile, rows
// ty*RQ + i, columns tx + 16 j, from tiles in shared memory; returns
// p = exp(s - lse) (0 for rows past S) and ds = p * (dp - delta) * scale.
template <int D, int RQ, int CK>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         int q0, int k0, const float* lse,
                                         const float* delta, int S,
                                         int causal, int window, float scale,
                                         float (&pr)[RQ][CK],
                                         float (&ds)[RQ][CK]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], dov[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = qs[(ty * RQ + i) * LD + d];
      dov[i] = dos[(ty * RQ + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = ks[(tx + 16 * j) * LD + d];
      vv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const float mk = mask(row, k0 + tx + 16 * j, S, causal, window);
      const float sv = __fadd_rn(__fmul_rn(s[i][j], scale), mk);
      const float e = row < S ? expf(sv - lse[i]) : 0.0f;
      pr[i][j] = e;
      ds[i][j] = __fmul_rn(__fmul_rn(e, __fsub_rn(dp[i][j], delta[i])),
                           scale);
    }
  }
}

template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdParams<T> p) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x LD
  float* dos = qs + BQ * LD;    // BQ x LD
  float* ks = dos + BQ * LD;    // BK x LD
  float* vs = ks + BK * LD;     // BK x LD
  float* dss = vs + BK * LD;    // BQ x LP

  const int n_q = (p.S + BQ - 1) / BQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qi * BQ;
  const int q_last = min(q0 + BQ, p.S) - 1;

  const T* kb = p.k + b * p.sk.b + kvh * p.sk.h;
  const T* vb = p.v + b * p.sv.b + kvh * p.sv.h;
  const T* ob = p.o + b * p.so.b + h * p.so.h;
  load_tile<D, BQ>(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.S,
                   p.dim);
  load_tile<D, BQ>(dos, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0,
                   p.S, p.dim);
  __syncthreads();

  // delta = rowsum(out * do) in fp32 for this tile's rows
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
  float lse[RQ], delta[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i, row = q0 + r;
    float part = 0.0f;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int d = tx + 16 * j;
        if (d < p.dim)
          part = fmaf(to_f(ob[row * p.so.s + d]), dos[r * LD + d], part);
      }
    }
    delta[i] = row_sum(part);
    lse[i] = row < p.S ? p.lse[row_base + row] : 0.0f;
    if (tx == 0 && row < p.S) p.delta[row_base + row] = delta[i];
  }

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.0f;

  int lo, hi;
  kv_tiles(q0, q_last, BK, p.S, p.causal, p.window, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * BK;
    __syncthreads();  // the previous tile's readers of ks, vs, dss are done
    load_tile<D, BK>(ks, kb, p.sk.s, k0, p.S, p.dim);
    load_tile<D, BK>(vs, vb, p.sv.s, k0, p.S, p.dim);
    __syncthreads();
    float pr[RQ][CK], ds[RQ][CK];
    p_and_ds<D, RQ, CK>(qs, dos, ks, vs, q0, k0, lse, delta, p.S, p.causal,
                        p.window, p.scale, pr, ds);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j)
        dss[(ty * RQ + i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float dsv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dss[(ty * RQ + i) * LP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      if (tx + 16 * j < p.dim)
        store_f(dqb + row * p.sdq.s + tx + 16 * j, acc[i][j]);
  }
}

template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdParams<T> p) {
  constexpr int RQ = BQ / 16, CK = BK / 16, RK = BK / 16, CD = D / 16;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x LD
  float* dos = qs + BQ * LD;    // BQ x LD
  float* ks = dos + BQ * LD;    // BK x LD
  float* vs = ks + BK * LD;     // BK x LD
  float* ps = vs + BK * LD;     // BQ x LP
  float* dss = ps + BQ * LP;    // BQ x LP
  float* lse_s = dss + BQ * LP;   // BQ
  float* delta_s = lse_s + BQ;    // BQ

  const int ki = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = ki * BK;

  load_tile<D, BK>(ks, p.k + b * p.sk.b + kvh * p.sk.h, p.sk.s, k0, p.S,
                   p.dim);
  load_tile<D, BK>(vs, p.v + b * p.sv.b + kvh * p.sv.h, p.sv.s, k0, p.S,
                   p.dim);

  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk[i][j] = dv[i][j] = 0.0f;

  int lo, hi;
  q_tiles(k0, BK, BQ, p.S, p.causal, p.window, &lo, &hi);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = p.q + b * p.sq.b + h * p.sq.h;
    const T* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int qi = lo; qi <= hi; ++qi) {
      const int q0 = qi * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, BQ>(qs, qb, p.sq.s, q0, p.S, p.dim);
      load_tile<D, BQ>(dos, dob, p.sdo.s, q0, p.S, p.dim);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int row = q0 + r;
        lse_s[r] = row < p.S ? p.lse[row_base + row] : 0.0f;
        delta_s[r] = row < p.S ? p.delta[row_base + row] : 0.0f;
      }
      __syncthreads();
      float lse[RQ], delta[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        lse[i] = lse_s[ty * RQ + i];
        delta[i] = delta_s[ty * RQ + i];
      }
      float pr[RQ][CK], ds[RQ][CK];
      p_and_ds<D, RQ, CK>(qs, dos, ks, vs, q0, k0, lse, delta, p.S,
                          p.causal, p.window, p.scale, pr, ds);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          ps[(ty * RQ + i) * LP + tx + 16 * j] = pr[i][j];
          dss[(ty * RQ + i) * LP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // this thread's key rows c = ty*RK + i, columns tx + 16 j
#pragma unroll 8
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], dsv[RK], dov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = ps[r * LP + ty * RK + i];
          dsv[i] = dss[r * LP + ty * RK + i];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          dov[j] = dos[r * LD + tx + 16 * j];
          qv[j] = qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) {
            dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
          }
      }
    }
  }

  T* dkb = p.dk + b * p.sdk.b + kvh * p.sdk.h;
  T* dvb = p.dv + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = k0 + ty * RK + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      if (tx + 16 * j >= p.dim) continue;
      store_f(dkb + row * p.sdk.s + tx + 16 * j, dk[i][j]);
      store_f(dvb + row * p.sdv.s + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_dq(const BwdParams<T>& p, int B, cudaStream_t stream) {
  auto kernel = dq_kernel<D, BQ, BK, T>;
  constexpr int smem = dq_smem<D, BQ, BK>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int BQ, int BK>
int launch_dkv(const BwdParams<T>& p, int B, cudaStream_t stream) {
  auto kernel = dkv_kernel<D, BQ, BK, T>;
  constexpr int smem = dkv_smem<D, BQ, BK>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BK - 1) / BK, p.KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// strides: (batch, head, row) of q, k, v, out, do, dq, dk, dv, in that
// order.
template <typename T>
BwdParams<T> bwd_params(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        const long long* st, int H, int KV, int S, int D,
                        int causal, int window) {
  return BwdParams<T>{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), strides_at(st, 6), strides_at(st, 7), H, KV, S,
      causal, window, D, softmax_scale(D)};
}

template <typename T>
int bwd_dq(const BwdParams<T>& p, int B, int D, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, launch_dq, T, p, B, st)
}

template <typename T>
int bwd_dkv(const BwdParams<T>& p, int B, int D, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, launch_dkv, T, p, B, st)
}

}  // namespace flash

// The two kernels' entry points share one argument list; flash_bwd_dq_*
// writes dq and delta and must run before flash_bwd_dkv_*, which reads
// delta and writes dk and dv (out and dq are unused by it).
#define FLASH_BWD_ENTRY(NAME, T, FN)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const void* lse,     \
                      void* delta, void* dq, void* dk, void* dv,            \
                      const long long* strides, int B, int H, int KV, int S, \
                      int D, int causal, int window, void* stream) {        \
    const auto p = flash::bwd_params<T>(q, k, v, o, dout, lse, delta, dq,   \
                                        dk, dv, strides, H, KV, S, D,       \
                                        causal, window);                    \
    return flash::FN<T>(p, B, D, stream);                                   \
  }

FLASH_BWD_ENTRY(flash_bwd_dq_f32, float, bwd_dq)
FLASH_BWD_ENTRY(flash_bwd_dq_bf16, __nv_bfloat16, bwd_dq)
FLASH_BWD_ENTRY(flash_bwd_dkv_f32, float, bwd_dkv)
FLASH_BWD_ENTRY(flash_bwd_dkv_bf16, __nv_bfloat16, bwd_dkv)

// -- tc route ----------------------------------------------------------

namespace flash {
namespace tc {

struct BwdArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides so, sdo, sdq, sdk, sdv;
  int H, KV, S, causal, window;
  int dim;  // the true head dim, <= D
  float scale;
};

// kDkvBQ: the query rows a dkv block takes at a time (on an H100 the
// backward at stablelm-12b's D 160 shape took 0.57 ms with 16 rows, 0.44
// with 32 and 0.36 with 64, profile.py --sections flash).
constexpr int kDqBQ = 64, kDqBK = 64, kDkvBQ = 64, kDkvBK = 64;

// dK/dV in two warpgroups (dkv_wide_tc_kernel) from head dim 128, in one
// (dkv_tc_kernel) below.  At D 128 one warpgroup's dK and dV sums and a
// tile's product leave room for a 16-row query slab only: on an H100 the
// backward at llava-next-34b's D 128 shape took 1.03 ms in one warpgroup
// and 0.83 in two; at the D 64 path shape, 0.64 in one and 0.92 in two
// (profile.py --sections flash).
template <int D>
constexpr bool dkv_wide() {
  return D >= 128;
}

template <int D>
constexpr int dq_smem() {
  return 1024 + 2 * Tile<D>::template bytes<kDqBQ>() +
         2 * kStages * Tile<D>::template bytes<kDqBK>();
}

template <int D>
constexpr int dkv_smem() {
  return 1024 + 2 * Tile<D>::template bytes<kDkvBK>() +
         2 * kStages * Tile<D>::template bytes<kDkvBQ>();
}

// dq (and delta): one warpgroup a (batch, head, 64-row query tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, BwdArgs p) {
  using T = Tile<D>;
  constexpr int BQ = kDqBQ, BK = kDqBK;
  constexpr int QB = T::template bytes<BQ>(), KB = T::template bytes<BK>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_k[kStages], bar_v[kStages];
  const uint32_t sq = smem_base(smem_raw), sdo = sq + QB;
  const uint32_t sk = sdo + QB, sv = sk + kStages * KB;

  const int n_q = (p.S + BQ - 1) / BQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qi * BQ;
  int lo, hi;
  kv_tiles(q0, min(q0 + BQ, p.S) - 1, BK, p.S, p.causal, p.window, &lo, &hi);
  const int n = hi - lo + 1;

  const int tid = threadIdx.x;
  auto load_stage = [&](int j) {  // K and V tile lo + j into stage j % 2
    const int s = j % kStages, k0 = (lo + j) * BK;
    mbar_expect(&bar_k[s], KB);
    T::template load<BK>(sk + s * KB, &tk, &bar_k[s], k0, kvh, b);
    mbar_expect(&bar_v[s], KB);
    T::template load<BK>(sv + s * KB, &tv, &bar_v[s], k0, kvh, b);
  };
  if (tid == 0) {
    mbar_init(&bar_q);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s]);
      mbar_init(&bar_v[s]);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar_q, 2 * QB);
    T::template load<BQ>(sq, &tq, &bar_q, q0, h, b);
    T::template load<BQ>(sdo, &tdo, &bar_q, q0, h, b);
    for (int j = 0; j < kStages && j < n; ++j) load_stage(j);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, t4 = lane % 4;
  const int dim = true_dim<D>(p.dim);

  // delta = rowsum(out * do) in fp32 for rows r0 and r0 + 8, each of the
  // row's four threads over a quarter of D; written for the dkv kernel
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
  const __nv_bfloat16* ob = p.o + b * p.so.b + h * p.so.h;
  const __nv_bfloat16* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    float part = 0.0f;
    if (row < p.S) {
      const __nv_bfloat16* orow = ob + row * p.so.s;
      const __nv_bfloat16* grow = dob + row * p.sdo.s;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int d = t4 * (D / 4) + 2 * c;
        if (d + 1 < dim) {
          const __nv_bfloat162 ov =
              *reinterpret_cast<const __nv_bfloat162*>(orow + d);
          const __nv_bfloat162 gv =
              *reinterpret_cast<const __nv_bfloat162*>(grow + d);
          part = fmaf(__bfloat162float(ov.x), __bfloat162float(gv.x), part);
          part = fmaf(__bfloat162float(ov.y), __bfloat162float(gv.y), part);
        } else if (d < dim) {
          part = fmaf(__bfloat162float(orow[d]), __bfloat162float(grow[d]),
                      part);
        }
      }
    }
    delta[i] = quad_sum(part);
    lse[i] = row < p.S ? p.lse[row_base + row] : 0.0f;
    if (t4 == 0 && row < p.S) p.delta[row_base + row] = delta[i];
  }

  float dq[T::DP / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) dq[i] = 0.0f;
  const float one[2] = {1.0f, 1.0f};

  mbar_wait(&bar_q, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = (lo + j) * BK;
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(&bar_k[s], parity);
    wg_fence();
    mma_dot<D, BK>(sc, sq, sk + s * KB);
    mbar_wait(&bar_v[s], parity);
    mma_dot<D, BK>(dp, sdo, sv + s * KB);
    wg_commit();
    wg_wait();
    fence_regs(sc);
    fence_regs(dp);

    // p = exp(s - lse), ds = p (dp - delta) scale, as the simt route
    scale_scores<BK, false>(
        sc, tile_open(q0, BQ, k0, BK, p.S, p.causal, p.window), p.scale,
        q0 + r0, k0, t4, p.S, p.causal, p.window);
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 4 * c + 2 * i + e;
          const float pe = exp_e(sc[f] - lse[i]);
          dp[f] = __fmul_rn(__fmul_rn(pe, __fsub_rn(dp[f], delta[i])),
                            p.scale);
        }

    // dq += ds.K, ds split into its bf16 parts (K read MN-major: keys
    // along the depth)
    uint32_t df[kSplit][BK / 16][4];
    split_frag<BK>(dp, df);
    add_products<D, BK>(dq, df, sk + s * KB, one);
    __syncthreads();  // every warp's reads of stage s are done
    if (tid == 0 && j + kStages < n) load_stage(j + kStages);
  }

  __nv_bfloat16* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store_cols(dqb + row * p.sdq.s, c, t4, dim, dq[4 * c + 2 * i],
                 dq[4 * c + 2 * i + 1]);
  }
}

// dk and dv: one warpgroup a (batch, kv head, 64-key tile), looping over
// the group's G query heads and, for each, the query tiles that see the
// keys (q_tiles); s^T = K.q^T and dp^T = V.do^T put p^T and ds^T in the
// accumulator layout, which is the A fragment of dv += p^T.do and
// dk += ds^T.q.  lse and delta of each step's query rows are staged in
// shared memory one step ahead (two buffers).
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, BwdArgs p) {
  using T = Tile<D>;
  constexpr int BK = kDkvBK, BQ = kDkvBQ;
  constexpr int KB = T::template bytes<BK>(), QB = T::template bytes<BQ>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, bar_q[kStages], bar_do[kStages];
  __shared__ float lse_s[kStages][BQ], delta_s[kStages][BQ];
  const uint32_t sk = smem_base(smem_raw), sv = sk + KB;
  const uint32_t sq = sv + KB, sdo = sq + kStages * QB;

  const int ki = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int k0 = ki * BK;
  int lo, hi;
  q_tiles(k0, BK, BQ, p.S, p.causal, p.window, &lo, &hi);
  const int nq = hi - lo + 1, n = G * nq;  // steps: (head g, query tile)

  const int tid = threadIdx.x;
  auto load_stage = [&](int j) {  // step j's q and do tiles into stage j % 2
    const int s = j % kStages;
    const int h = kvh * G + j / nq, q0 = (lo + j % nq) * BQ;
    mbar_expect(&bar_q[s], QB);
    T::template load<BQ>(sq + s * QB, &tq, &bar_q[s], q0, h, b);
    mbar_expect(&bar_do[s], QB);
    T::template load<BQ>(sdo + s * QB, &tdo, &bar_do[s], q0, h, b);
  };
  auto stage_rows = [&](int j) {  // lse and delta of step j's query rows
    const int s = j % kStages;
    const int h = kvh * G + j / nq, q0 = (lo + j % nq) * BQ;
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int r = tid; r < 2 * BQ; r += kThreads) {
      const int row = q0 + r % BQ;
      const float* src = r < BQ ? p.lse : p.delta;
      const float v = row < p.S ? src[row_base + row] : 0.0f;
      if (r < BQ)
        lse_s[s][r] = v;
      else
        delta_s[s][r - BQ] = v;
    }
  };
  if (tid == 0) {
    mbar_init(&bar_kv);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_q[s]);
      mbar_init(&bar_do[s]);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar_kv, 2 * KB);
    T::template load<BK>(sk, &tk, &bar_kv, k0, kvh, b);
    T::template load<BK>(sv, &tv, &bar_kv, k0, kvh, b);
    for (int j = 0; j < kStages && j < n; ++j) load_stage(j);
  }
  stage_rows(0);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, t4 = lane % 4;  // key rows r0, r0+8
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  mbar_wait(&bar_kv, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int q0 = (lo + j % nq) * BQ;
    float st[BQ / 2], dpt[BQ / 2];
    mbar_wait(&bar_q[s], parity);
    wg_fence();
    mma_dot<D, BQ>(st, sk, sq + s * QB);
    mbar_wait(&bar_do[s], parity);
    mma_dot<D, BQ>(dpt, sv, sdo + s * QB);
    wg_commit();
    wg_wait();
    fence_regs(st);
    fence_regs(dpt);

    // p^T and ds^T: entry (key r0 + 8 i, query column 8 c + 2 t4 + e)
    scale_scores<BQ, true>(
        st, tile_open(q0, BQ, k0, BK, p.S, p.causal, p.window), p.scale,
        k0 + r0, q0, t4, p.S, p.causal, p.window);
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + 2 * t4 + e;
        const float lse = lse_s[s][col], delta = delta_s[s][col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int f = 4 * c + 2 * i + e;
          const float pe = exp_e(st[f] - lse);
          st[f] = pe;
          dpt[f] = __fmul_rn(__fmul_rn(pe, __fsub_rn(dpt[f], delta)),
                             p.scale);
        }
      }

    // dv += p^T.do, then dk += ds^T.q, each split into its bf16 parts;
    // ds^T is split while the dv products run
    float part[D / 2];
    uint32_t pf[kSplit][BQ / 16][4];
    split_frag<BQ>(st, pf);
    wg_fence();
    mma_split<D, BQ>(part, pf, sdo + s * QB);
    wg_commit();
    uint32_t df[kSplit][BQ / 16][4];
    split_frag<BQ>(dpt, df);
    wg_wait();
    fence_regs(part);
    keep(pf);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] += part[i];
    wg_fence();
    mma_split<D, BQ>(part, df, sq + s * QB);
    wg_commit();
    if (j + 1 < n) stage_rows(j + 1);  // the buffer step j - 1 read
    wg_wait();
    fence_regs(part);
    keep(df);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] += part[i];
    __syncthreads();  // stage s is read; step j + 1's rows are staged
    if (tid == 0 && j + kStages < n) load_stage(j + kStages);
  }

  __nv_bfloat16* dkb = p.dk + b * p.sdk.b + kvh * p.sdk.h;
  __nv_bfloat16* dvb = p.dv + b * p.sdv.b + kvh * p.sdv.h;
  const int dim = true_dim<D>(p.dim);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + 8 * i;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      store_cols(dkb + row * p.sdk.s, c, t4, dim, dk[4 * c + 2 * i],
                 dk[4 * c + 2 * i + 1]);
      store_cols(dvb + row * p.sdv.s, c, t4, dim, dv[4 * c + 2 * i],
                 dv[4 * c + 2 * i + 1]);
    }
  }
}

// dk and dv from head dim 128 (dkv_wide): one warpgroup's dK and dV sums
// (64 keys x D fp32 each) take D registers a thread, all 255 at D 256.
// So two warpgroups a (batch, kv head, 64-key tile) split them:
// warpgroup 0 forms s^T = K.q^T and p^T and sums dv += p^T.do, warpgroup
// 1 forms dp^T = V.do^T, reads p^T from shared memory and sums dk +=
// ds^T.q.  Each holds one D-wide sum and one product of CP panels
// (add_products), so the query slab is 64 rows; p^T is computed once,
// with the numerics of dkv_tc_kernel.  The two warpgroups' accumulator
// fragments are laid out alike, so a thread of warpgroup 1 reads exactly
// the p^T entries its namesake in warpgroup 0 wrote.  Two block-wide barriers a
// step: p^T written, then the stage read.  Shared memory at D 256: K and
// V 64 KB + 2 stages x (q + do) 128 KB.

template <int D>
__global__ void __launch_bounds__(2 * kThreads)
    dkv_wide_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, BwdArgs p) {
  using T = Tile<D>;
  constexpr int BK = kDkvBK, BQ = kDkvBQ;
  constexpr int KB = T::template bytes<BK>(), QB = T::template bytes<BQ>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, bar_q[kStages], bar_do[kStages];
  __shared__ float lse_s[kStages][BQ], delta_s[kStages][BQ];
  __shared__ float pt_s[BQ / 2][kThreads];  // p^T entry e of thread t
  const uint32_t sk = smem_base(smem_raw), sv = sk + KB;
  const uint32_t sq = sv + KB, sdo = sq + kStages * QB;

  const int ki = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int k0 = ki * BK;
  int lo, hi;
  q_tiles(k0, BK, BQ, p.S, p.causal, p.window, &lo, &hi);
  const int nq = hi - lo + 1, n = G * nq;  // steps: (head g, query tile)

  const int tid = threadIdx.x, wg = tid / kThreads, t = tid % kThreads;
  auto load_stage = [&](int j) {  // step j's q and do tiles into stage j % 2
    const int s = j % kStages;
    const int h = kvh * G + j / nq, q0 = (lo + j % nq) * BQ;
    mbar_expect(&bar_q[s], QB);
    T::template load<BQ>(sq + s * QB, &tq, &bar_q[s], q0, h, b);
    mbar_expect(&bar_do[s], QB);
    T::template load<BQ>(sdo + s * QB, &tdo, &bar_do[s], q0, h, b);
  };
  auto stage_rows = [&](int j) {  // lse and delta of step j's query rows
    const int s = j % kStages;
    const int h = kvh * G + j / nq, q0 = (lo + j % nq) * BQ;
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int r = tid; r < 2 * BQ; r += 2 * kThreads) {
      const int row = q0 + r % BQ;
      const float* src = r < BQ ? p.lse : p.delta;
      const float v = row < p.S ? src[row_base + row] : 0.0f;
      if (r < BQ)
        lse_s[s][r] = v;
      else
        delta_s[s][r - BQ] = v;
    }
  };
  if (tid == 0) {
    mbar_init(&bar_kv);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_q[s]);
      mbar_init(&bar_do[s]);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar_kv, 2 * KB);
    T::template load<BK>(sk, &tk, &bar_kv, k0, kvh, b);
    T::template load<BK>(sv, &tv, &bar_kv, k0, kvh, b);
    for (int j = 0; j < kStages && j < n; ++j) load_stage(j);
  }
  stage_rows(0);
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4, t4 = lane % 4;  // key rows r0, r0+8
  float acc[T::DP / 2];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) acc[i] = 0.0f;
  const float one[2] = {1.0f, 1.0f};
  // s^T against q (warpgroup 0) or dp^T against do (1); then the sum's
  // product against do (dv += p^T.do) or q (dk += ds^T.q)
  const uint32_t lhs = wg == 0 ? sk : sv;
  const uint32_t rows_a = wg == 0 ? sq : sdo, rows_b = wg == 0 ? sdo : sq;

  mbar_wait(&bar_kv, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int q0 = (lo + j % nq) * BQ;
    float x[BQ / 2];  // s^T then p^T (warpgroup 0); dp^T then ds^T (1)
    mbar_wait(&bar_q[s], parity);
    mbar_wait(&bar_do[s], parity);
    wg_fence();
    mma_dot<D, BQ>(x, lhs, rows_a + s * QB);
    wg_commit();
    wg_wait();
    fence_regs(x);
    if (wg == 0) {
      // p^T: entry (key r0 + 8 i, query column 8 c + 2 t4 + e)
      scale_scores<BQ, true>(
          x, tile_open(q0, BQ, k0, BK, p.S, p.causal, p.window), p.scale,
          k0 + r0, q0, t4, p.S, p.causal, p.window);
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse = lse_s[s][8 * c + 2 * t4 + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int f = 4 * c + 2 * i + e;
            x[f] = exp_e(x[f] - lse);
            pt_s[f][t] = x[f];
          }
        }
    }
    __syncthreads();  // p^T is in shared memory
    if (wg == 1) {
      // ds^T = p^T (dp^T - delta) scale
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float delta = delta_s[s][8 * c + 2 * t4 + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int f = 4 * c + 2 * i + e;
            x[f] = __fmul_rn(__fmul_rn(pt_s[f][t], __fsub_rn(x[f], delta)),
                             p.scale);
          }
        }
    } else if (j + 1 < n) {
      stage_rows(j + 1);  // the buffer step j - 1 read
    }
    uint32_t xf[kSplit][BQ / 16][4];
    split_frag<BQ>(x, xf);
    add_products<D, BQ>(acc, xf, rows_b + s * QB, one);
    __syncthreads();  // stage s and p^T are read; step j + 1's rows staged
    if (tid == 0 && j + kStages < n) load_stage(j + kStages);
  }

  __nv_bfloat16* out = wg == 0 ? p.dv + b * p.sdv.b + kvh * p.sdv.h
                               : p.dk + b * p.sdk.b + kvh * p.sdk.h;
  const long long ld = wg == 0 ? p.sdv.s : p.sdk.s;
  const int dim = true_dim<D>(p.dim);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + 8 * i;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store_cols(out + row * ld, c, t4, dim, acc[4 * c + 2 * i],
                 acc[4 * c + 2 * i + 1]);
  }
}

// The tensor maps of q, k, v and do with boxes of `bq` query rows and
// `bk` keys.
template <int D>
int bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
             const void* v, const void* dout, const long long* st, int B,
             const BwdArgs& a, int bq, int bk) {
  const int H = a.H, KV = a.KV, S = a.S, dim = a.dim;
  int err = make_map<D>(&maps[0], q, strides_at(st, 0), B, H, S, bq, dim);
  if (!err)
    err = make_map<D>(&maps[1], k, strides_at(st, 1), B, KV, S, bk, dim);
  if (!err)
    err = make_map<D>(&maps[2], v, strides_at(st, 2), B, KV, S, bk, dim);
  if (!err)
    err = make_map<D>(&maps[3], dout, strides_at(st, 4), B, H, S, bq, dim);
  return err;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const BwdArgs& a, const long long* st, int B,
              cudaStream_t stream) {
  CUtensorMap m[4];
  const int err = bwd_maps<D>(m, q, k, v, dout, st, B, a, kDqBQ, kDqBK);
  if (err) return err;
  auto kernel = dq_tc_kernel<D>;
  constexpr int smem = dq_smem<D>();
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.S + kDqBQ - 1) / kDqBQ, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const BwdArgs& a, const long long* st, int B,
               cudaStream_t stream) {
  CUtensorMap m[4];
  const int err = bwd_maps<D>(m, q, k, v, dout, st, B, a, kDkvBQ,
                              kDkvBK);
  if (err) return err;
  const dim3 grid((a.S + kDkvBK - 1) / kDkvBK, a.KV, B);
  constexpr int smem = dkv_smem<D>();
  if constexpr (dkv_wide<D>()) {
    auto kernel = dkv_wide_tc_kernel<D>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, 2 * kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  } else {
    auto kernel = dkv_tc_kernel<D>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace flash

// The tc route's entry points take the simt route's argument list (q, v
// and do through tensor maps; out only for delta).
#define FLASH_BWD_TC_ENTRY(NAME, FN)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const void* lse,     \
                      void* delta, void* dq, void* dk, void* dv,            \
                      const long long* strides, int B, int H, int KV, int S, \
                      int D, int causal, int window, void* stream) {        \
    using flash::strides_at;                                                \
    const flash::tc::BwdArgs a{                                             \
        static_cast<const __nv_bfloat16*>(o),                               \
        static_cast<const __nv_bfloat16*>(dout),                            \
        static_cast<const float*>(lse), static_cast<float*>(delta),         \
        static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),   \
        static_cast<__nv_bfloat16*>(dv), strides_at(strides, 3),            \
        strides_at(strides, 4), strides_at(strides, 5),                     \
        strides_at(strides, 6), strides_at(strides, 7), H, KV, S, causal,   \
        window, D, flash::softmax_scale(D)};                                \
    const auto st = static_cast<cudaStream_t>(stream);                      \
    FLASH_TC_DISPATCH_D(D, flash::tc::FN, q, k, v, dout, a, strides, B, st) \
  }

FLASH_BWD_TC_ENTRY(flash_bwd_dq_bf16_tc, launch_dq)
FLASH_BWD_TC_ENTRY(flash_bwd_dkv_bf16_tc, launch_dkv)
