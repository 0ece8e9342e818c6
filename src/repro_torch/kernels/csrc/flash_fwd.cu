// FlashAttention-2 forward: causal and sliding-window masks, GQA by
// index, out and the row logsumexp, on the tensor cores (tc route) or the
// CUDA cores (simt route).
//
// Replaces the TPU kernel flash_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:102), whose grid
// (B, H, S/bq, S/bk) runs the KV axis in sequence with (m, l, acc) in
// VMEM scratch.  Here one block owns one (batch, head, query tile) and
// loops over the KV tiles itself, keeping m and l per row and the
// (rows x D) accumulator in registers.  KV tiles that hold no attendable
// entry are skipped (kv_tiles in flash_attention.cuh), so causal
// attention visits half the tiles and a window of W about W/64 per query
// tile.  Blocks are numbered so that the longest query tiles (the last
// rows under a causal mask) start first.
//
// Bound: operations.  4 B H S_eff S D flops (S_eff = S/2 causal) against
// O(S D) bytes; on the tensor cores (989 TFLOP/s bf16) the path's shape
// (B 4, H 15, S 2048, D 64) would take 0.033 ms.
//
// Two routes, chosen by the wrapper (ops.route):
//   * tc (bf16 at D 16/32/64/128 and 129-256, flash_fwd_bf16_tc): one
//     warpgroup a 64-row query tile, q loaded once by TMA, K and V tiles
//     of 64 keys streaming through a two-stage TMA/mbarrier ring, s =
//     q.k^T and p.V on wgmma with p split into three bf16 parts, each
//     tile's p.V added to the rescaled fp32 accumulator in registers
//     (flash_tc.cuh); the mask is applied only on tiles that cross the
//     diagonal, the window edge or S.  Above D 128 (run at 160 or 256,
//     TMA zero-filling the columns past the true D) p.V runs one 64-column
//     panel at a time, so o (D / 2 registers a thread) and one panel's
//     product (32) fit beside p's parts, and a block is two warpgroups on
//     128 query rows sharing each K and V tile (fwd_wgs): its shared
//     memory at D 256, q 64 KB + 2 stages x (K + V) 128 KB, leaves one
//     block to an SM.
//   * simt (fp32, and bf16 at the other head dims below 128:
//     flash_fwd_f32, flash_fwd_bf16; a head dim is run at the next
//     compiled one, flash_attention.cuh): the first version: 256
//     threads a 64-row tile (32 at D 256), K and V in
//     shared memory as fp32, register-tiled dots (4 x 4 a thread), p
//     through shared memory.  Its inner loops run one shared-memory load
//     per two FMAs, so shared-memory bandwidth, not the FMA rate (67
//     TFLOP/s fp32), sets its time.
#include "flash_attention.cuh"
#include "flash_tc.cuh"

namespace flash {

template <typename T>
struct FwdParams {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;
  Strides sq, sk, sv, so;
  int H, KV, S, causal, window;
  int dim;  // the true head dim, <= D
  float scale;
};

template <int D, int BQ, int BK>
constexpr int fwd_smem() {
  return 4 * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdParams<T> p) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* ks = qs + BQ * LD;    // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* ps = vs + BK * LD;    // BQ x LP

  const int n_q = (p.S + BQ - 1) / BQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qi * BQ;
  const int q_last = min(q0 + BQ, p.S) - 1;

  const T* qb = p.q + b * p.sq.b + h * p.sq.h;
  const T* kb = p.k + b * p.sk.b + kvh * p.sk.h;
  const T* vb = p.v + b * p.sv.b + kvh * p.sv.h;
  load_tile<D, BQ>(qs, qb, p.sq.s, q0, p.S, p.dim);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.0f;
  }

  int lo, hi;
  kv_tiles(q0, q_last, BK, p.S, p.causal, p.window, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * BK;
    __syncthreads();  // the previous tile's readers of ks, vs, ps are done
    load_tile<D, BK>(ks, kb, p.sk.s, k0, p.S, p.dim);
    load_tile<D, BK>(vs, vb, p.sv.s, k0, p.S, p.dim);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty * RQ + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float mk = mask(q0 + r, k0 + tx + 16 * j, p.S, p.causal,
                              p.window);
        s[i][j] = __fadd_rn(__fmul_rn(s[i][j], p.scale), mk);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[r * LP + tx + 16 * j] = e;
        sum += e;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty * RQ + i) * LP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = p.o + b * p.so.b + h * p.so.h;
  float* lb = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= p.S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      if (tx + 16 * j < p.dim)
        store_f(ob + row * p.so.s + tx + 16 * j, acc[i][j] / li);
    if (tx == 0) lb[row] = m[i] + logf(li);
  }
}

template <typename T, int D, int BQ, int BK>
int launch_fwd(const FwdParams<T>& p, int B, cudaStream_t stream) {
  auto kernel = fwd_kernel<D, BQ, BK, T>;
  constexpr int smem = fwd_smem<D, BQ, BK>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// strides: (batch, head, row) of q, k, v, out, in that order.
template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const long long* strides, int B, int H, int KV, int S, int D,
        int causal, int window, void* stream) {
  FwdParams<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<T*>(o),
                 static_cast<float*>(lse), strides_at(strides, 0),
                 strides_at(strides, 1), strides_at(strides, 2),
                 strides_at(strides, 3), H, KV, S, causal, window, D,
                 softmax_scale(D)};
  const auto st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, launch_fwd, T, p, B, st)
}

}  // namespace flash

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int H, int KV, int S, int D, int causal,
                             int window, void* stream) {
  return flash::fwd<float>(q, k, v, o, lse, strides, B, H, KV, S, D, causal,
                           window, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* strides,
                              int B, int H, int KV, int S, int D, int causal,
                              int window, void* stream) {
  return flash::fwd<__nv_bfloat16>(q, k, v, o, lse, strides, B, H, KV, S, D,
                                   causal, window, stream);
}

// -- tc route ----------------------------------------------------------

namespace flash {
namespace tc {

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;
  Strides so;
  int H, KV, S, causal, window;
  int dim;  // the true head dim, <= D
  float scale;
};

constexpr int kFwdBK = 64;

// Warpgroups a block: above head dim 128, where a block's shared memory
// leaves one to an SM, two, each on 64 of its 128 query rows, so one
// warpgroup's softmax runs beside the other's products and each K and V
// tile serves twice the rows.
template <int D>
constexpr __host__ __device__ int fwd_wgs() {
  return D > 128 ? 2 : 1;
}

template <int D>
constexpr int fwd_smem() {
  return 1024 + Tile<D>::template bytes<64 * fwd_wgs<D>()>() +
         2 * kStages * Tile<D>::template bytes<kFwdBK>();
}

template <int D>
__global__ void __launch_bounds__(fwd_wgs<D>() * kThreads)
    fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, FwdArgs p) {
  using T = Tile<D>;
  constexpr int BQ = 64 * fwd_wgs<D>(), BK = kFwdBK;
  constexpr int QB = T::template bytes<BQ>(), KB = T::template bytes<BK>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_k[kStages], bar_v[kStages];
  const uint32_t sq = smem_base(smem_raw);
  const uint32_t sk = sq + QB, sv = sk + kStages * KB;

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
    mbar_expect(&bar_q, QB);
    T::template load<BQ>(sq, &tq, &bar_q, q0, h, b);
    for (int j = 0; j < kStages && j < n; ++j) load_stage(j);
  }

  // this warpgroup's 64 rows from qw on (q at sqw); this thread's rows of
  // them: r0 and r0 + 8; its columns of each 8-column chunk c: 8 c + 2 t4
  // and the next
  const int wg = fwd_wgs<D>() > 1 ? tid / kThreads : 0;
  const int warp = tid % kThreads / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, t4 = lane % 4;
  const int qw = q0 + 64 * wg;
  const uint32_t sqw = sq + 64 * wg * T::ROWB;
  float o[T::DP / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  mbar_wait(&bar_q, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = (lo + j) * BK;
    float sc[BK / 2];
    mbar_wait(&bar_k[s], parity);
    wg_fence();
    mma_dot<D, BK, BQ>(sc, sqw, sk + s * KB);
    wg_commit();
    wg_wait();
    fence_regs(sc);

    // s = q.k * scale (+ mask), the online softmax in fp32
    scale_scores<BK, false>(
        sc, tile_open(qw, 64, k0, BK, p.S, p.causal, p.window), p.scale,
        qw + r0, k0, t4, p.S, p.causal, p.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mx[i] = fmaxf(mx[i], sc[4 * c + 2 * i + e]);
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp_e(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = exp_e(sc[4 * c + 2 * i + e] - m[i]);
          sc[4 * c + 2 * i + e] = x;
          sum[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);

    // o = o alpha + p.V, p split into its bf16 parts
    uint32_t pf[kSplit][BK / 16][4];
    split_frag<BK>(sc, pf);
    mbar_wait(&bar_v[s], parity);
    add_products<D, BK>(o, pf, sv + s * KB, alpha);
    __syncthreads();  // every warp's reads of stage s are done
    if (tid == 0 && j + kStages < n) load_stage(j + kStages);
  }

  __nv_bfloat16* ob = p.o + b * p.so.b + h * p.so.h;
  float* lb = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
  const int dim = true_dim<D>(p.dim);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r0 + 8 * i;
    if (row >= p.S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store_cols(ob + row * p.so.s, c, t4, dim,
                 o[4 * c + 2 * i] / li, o[4 * c + 2 * i + 1] / li);
    if (t4 == 0) lb[row] = m[i] + logf(li);
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const FwdArgs& a, const long long* st, int B,
               cudaStream_t stream) {
  constexpr int bq = 64 * fwd_wgs<D>();
  CUtensorMap tq, tk, tv;
  int err = make_map<D>(&tq, q, strides_at(st, 0), B, a.H, a.S, bq, a.dim);
  if (!err)
    err = make_map<D>(&tk, k, strides_at(st, 1), B, a.KV, a.S, kFwdBK, a.dim);
  if (!err)
    err = make_map<D>(&tv, v, strides_at(st, 2), B, a.KV, a.S, kFwdBK, a.dim);
  if (err) return err;
  auto kernel = fwd_tc_kernel<D>;
  constexpr int smem = fwd_smem<D>();
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.S + bq - 1) / bq, a.H, B);
  kernel<<<grid, fwd_wgs<D>() * kThreads, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace flash

extern "C" int flash_fwd_bf16_tc(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const long long* strides,
                                 int B, int H, int KV, int S, int D,
                                 int causal, int window, void* stream) {
  const flash::tc::FwdArgs a{
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      flash::strides_at(strides, 3), H, KV, S, causal, window, D,
      flash::softmax_scale(D)};
  const auto st = static_cast<cudaStream_t>(stream);
  FLASH_TC_DISPATCH_D(D, flash::tc::launch_fwd, q, k, v, a, strides, B, st)
}
