// FlashAttention-2 backward on the CUDA cores: a dQ kernel and a dK/dV
// kernel, both recomputing p = exp(s - lse) from the forward's row
// logsumexp.
//
// Replaces the TPU kernel flash_bwd
// (src/repro/kernels/flash_attention/flash_attention.py:232): its
// _dkv_kernel (pallas_call at :241) and _dq_kernel (:270), the delta =
// rowsum(o * do) it computes in XLA (:237), and the sum over each kv
// head's group of query heads that its custom VJP does afterwards
// (ops.py:95-96).
//
//   * dq kernel: one block per (batch, head, query tile).  Its prologue
//     computes delta for the tile's rows from out and do and writes it to
//     global memory for the dK/dV kernel; then it loops over the KV tiles
//     the rows can see (kv_tiles), recomputes s and p, forms dp = do.v
//     and ds = p * (dp - delta) * scale in registers, stages ds in shared
//     memory and accumulates dq += ds @ K in registers.
//   * dkv kernel: one block per (batch, kv head, KV tile).  It loops over
//     the G query heads of the kv head and, for each, over the query
//     tiles that can see the KV tile (q_tiles), stages p and ds in shared
//     memory and accumulates dv += p^T @ do and dk += ds^T @ q in
//     registers.  The group sum of dk and dv is so taken inside the block:
//     no atomics and no (B, H, S, D) per-query-head intermediates, and two
//     calls give bitwise the same gradients.
//
// The dq kernel runs first (the dkv kernel reads its delta).  Masks,
// tile skipping and the -1e30 convention are the forward's
// (flash_attention.cuh); a masked entry has p = exp(-1e30 - lse) = 0 and
// adds exactly zero, and query rows past S are given p = 0.
//
// Bound: operations.  About 2.5x the forward's flops (s and dp, then dq,
// dk and dv: five products of the forward's size, against its two).  Like
// the forward this first version runs on the CUDA cores and is bound by
// shared-memory loads; wgmma tiles are the next step.
#include "flash_attention.cuh"

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
  load_tile<D, BQ>(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.S);
  load_tile<D, BQ>(dos, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0,
                   p.S);
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
    load_tile<D, BK>(ks, kb, p.sk.s, k0, p.S);
    load_tile<D, BK>(vs, vb, p.sv.s, k0, p.S);
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

  load_tile<D, BK>(ks, p.k + b * p.sk.b + kvh * p.sk.h, p.sk.s, k0, p.S);
  load_tile<D, BK>(vs, p.v + b * p.sv.b + kvh * p.sv.h, p.sv.s, k0, p.S);

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
      load_tile<D, BQ>(qs, qb, p.sq.s, q0, p.S);
      load_tile<D, BQ>(dos, dob, p.sdo.s, q0, p.S);
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
      store_f(dkb + row * p.sdk.s + tx + 16 * j, dk[i][j]);
      store_f(dvb + row * p.sdv.s + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_dq(const BwdParams<T>& p, int B, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = dq_kernel<D, BQ, BK, T>;
  constexpr int smem = dq_smem<D, BQ, BK>();
  const cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int BQ, int BK>
int launch_dkv(const BwdParams<T>& p, int B, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = dkv_kernel<D, BQ, BK, T>;
  constexpr int smem = dkv_smem<D, BQ, BK>();
  const cudaError_t err = allow_smem(kernel, smem, &smem_set);
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
      causal, window, softmax_scale(D)};
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
