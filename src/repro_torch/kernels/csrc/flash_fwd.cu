// FlashAttention-2 forward on the CUDA cores: causal and sliding-window
// masks, GQA by index, out and the row logsumexp.
//
// Replaces the TPU kernel flash_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:102), whose grid
// (B, H, S/bq, S/bk) runs the KV axis in sequence with (m, l, acc) in
// VMEM scratch.  Here one block of 256 threads owns one (batch, head,
// query tile of 64 rows; 32 at D = 256) and loops over the KV tiles
// itself, keeping m and l per row and the (64 x D) accumulator in
// registers (each thread 4 rows x D/16 columns).  Per KV tile: K and V go
// to shared memory as fp32, the 64 x 64 scores are a register-tiled dot
// over D (4 x 4 a thread), each row's max and sum are half-warp
// shuffles, p goes to shared memory, and the accumulator is rescaled by
// alpha and gains p @ V.  KV tiles that hold no attendable entry are
// skipped (kv_tiles in flash_attention.cuh), so causal attention visits
// half the tiles and a window of W about W/64 per query tile.  Blocks are
// numbered so that the longest query tiles (the last rows under a causal
// mask) start first.
//
// Bound: operations.  4 B H S_eff S D flops (S_eff = S/2 causal) against
// O(S D) bytes; on the tensor cores (989 TFLOP/s bf16) the path's shape
// (B 4, H 15, S 2048, D 64) would take 0.033 ms.  This first version runs
// on the CUDA cores (67 TFLOP/s fp32), and its inner loops run one
// shared-memory load per two FMAs, so shared-memory bandwidth, not the
// FMA rate, sets its time.  wgmma tensor-core tiles fed by TMA are the
// next step.
#include "flash_attention.cuh"

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
  load_tile<D, BQ>(qs, qb, p.sq.s, q0, p.S);

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
    load_tile<D, BK>(ks, kb, p.sk.s, k0, p.S);
    load_tile<D, BK>(vs, vb, p.sv.s, k0, p.S);
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
      store_f(ob + row * p.so.s + tx + 16 * j, acc[i][j] / li);
    if (tx == 0) lb[row] = m[i] + logf(li);
  }
}

template <typename T, int D, int BQ, int BK>
int launch_fwd(const FwdParams<T>& p, int B, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = fwd_kernel<D, BQ, BK, T>;
  constexpr int smem = fwd_smem<D, BQ, BK>();
  const cudaError_t err = allow_smem(kernel, smem, &smem_set);
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
                 strides_at(strides, 3), H, KV, S, causal, window,
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
