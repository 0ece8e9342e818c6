// One-token grouped-query attention decode read through a block table:
// the body shared by paged_gqa.cu (bf16/fp32 pools) and paged_gqa_q8.cu
// (int8 pools with one float32 scale per (page, kv head)).
//
// q (B, H, hd); pools (P, ps, KV, hd); bt (B, bt_cols) int32 page ids;
// pos (B,) int32 -> out (B, H, hd) in q's type.  Query head h reads kv
// head h / G (G = H / KV).  Entry j of request b's chain is
// pool[bt[b, j / ps], j % ps]; with a window the chain is a ring of
// `length` entries and entry j holds position pos - ((pos - j) mod length).
//
// Design: one block per (kv head, request), so the G query rows that
// share a kv head read each page once.  The block walks the request's
// pages in order and stops at the first page with no attendable entry
// (p*ps > pos or p*ps >= length); every page it reads therefore holds at
// least one unmasked entry, which keeps the online softmax sound (a
// fully masked first page would set the running max to -1e30).  Per
// page: K and V rows of this kv head go to shared memory as fp32 (int8
// codes times the page's scale), every (row, entry) score is one dot
// over hd plus the mask, one thread per query row updates (m, l) and
// turns the scores into weights, and the accumulator (G x hd, fp32, in
// shared memory) is rescaled and gains weights @ V.  The output is
// acc / max(l, 1e-30).  Scores, softmax and sums are all fp32, as in
// the TPU kernel; the summation order differs from the plain version's
// (one global max), so the two agree to ~1e-7, not bit for bit.
//
// Bound: bytes.  The live pages are read once (2 * pages * ps * hd
// elements per (b, kv)) and q/out once; the flops are 4 * B * H * T * hd.
// This first version is far from that bound: B * KV blocks only (20 for
// smollm-360m at 4 slots), each a serial walk over its pages with four
// barriers per page and no loads in flight across pages.  Splitting the
// walk over pages across blocks (flash-decoding) and cp.async/TMA page
// prefetch are the next steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_gqa {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Python's (floor) modulo for a positive divisor, as jnp and torch use.
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Additive mask of in-cache entry j for a query at pos (_page_mask).
__device__ __forceinline__ float entry_mask(int j, int pos, int length,
                                            int window) {
  const int k_pos = window < 0 ? j : pos - floor_mod(pos - j, length);
  bool ok = j < length && k_pos >= 0 && k_pos <= pos;
  if (window >= 0) ok = ok && (pos - k_pos) < window;
  return ok ? 0.0f : kNegInf;
}

// kScaled: multiply each page row by ks/vs[page * KV + kv] (int8 pools).
template <typename TQ, typename TKV, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                  const TKV* __restrict__ pool_v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ bt, const int* __restrict__ pos_b,
                  TQ* __restrict__ out, int H, int KV, int hd, int ps,
                  int bt_cols, int length, int window, float scale) {
  extern __shared__ float smem[];
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  float* qs = smem;             // G * hd
  float* acc = qs + G * hd;     // G * hd
  float* ks = acc + G * hd;     // ps * hd
  float* vs = ks + ps * hd;     // ps * hd
  float* sc = vs + ps * hd;     // G * ps
  float* m = sc + G * ps;       // G
  float* l = m + G;             // G
  float* alpha = l + G;         // G

  const int pos = pos_b[b];
  const int64_t qoff = (static_cast<int64_t>(b) * H + kv * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.0f;
  }
  if (tid < G) {
    m[tid] = kNegInf;
    l[tid] = 0.0f;
  }
  const int n_pages = (length + ps - 1) / ps;
  for (int p = 0; p < n_pages; ++p) {
    // pages past the first unattendable one are unwritten chain tails
    if (p * ps > pos || p * ps >= length) break;
    const int64_t page = bt[static_cast<int64_t>(b) * bt_cols + p];
    float kmul = 1.0f, vmul = 1.0f;
    if (kScaled) {
      kmul = k_scale[page * KV + kv];
      vmul = v_scale[page * KV + kv];
    }
    __syncthreads();  // the previous page's readers are done
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      const int64_t off = ((page * ps + t) * KV + kv) * hd + d;
      float kx = to_f(pool_k[off]), vx = to_f(pool_v[off]);
      if (kScaled) {
        kx = kx * kmul;
        vx = vx * vmul;
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * ps; i += kThreads) {
      const int g = i / ps, t = i - g * ps;
      const float* qr = qs + g * hd;
      const float* kr = ks + t * hd;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc[i] = dot * scale + entry_mask(p * ps + t, pos, length, window);
    }
    __syncthreads();
    if (tid < G) {
      float* s = sc + tid * ps;
      float mx = s[0];
      for (int t = 1; t < ps; ++t) mx = fmaxf(mx, s[t]);
      const float m_new = fmaxf(m[tid], mx);
      float sum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float e = expf(s[t] - m_new);
        s[t] = e;
        sum += e;
      }
      const float a = expf(m[tid] - m_new);
      l[tid] = l[tid] * a + sum;
      m[tid] = m_new;
      alpha[tid] = a;
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* w = sc + g * ps;
      float pv = 0.0f;
      for (int t = 0; t < ps; ++t) pv = fmaf(w[t], vs[t * hd + d], pv);
      acc[i] = acc[i] * alpha[g] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    store_f(out + qoff + i, acc[i] / fmaxf(l[i / hd], 1e-30f));
  }
}

template <typename TQ, typename TKV, bool kScaled>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* k_scale, const void* v_scale, const void* bt,
           const void* pos, void* out, int B, int H, int KV, int hd, int ps,
           int bt_cols, int length, int window, int smem, void* stream) {
  auto kernel = decode_kernel<TQ, TKV, kScaled>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the reference's 1.0 / (hd ** 0.5), a double rounded once to fp32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const dim3 grid(KV, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<TQ*>(out), H, KV, hd, ps,
      bt_cols, length, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged_gqa
