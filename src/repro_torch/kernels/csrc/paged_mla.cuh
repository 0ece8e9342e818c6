// One-token weight-absorbed MLA decode read through a block table: the
// CUDA-core ("simt") route shared by paged_mla.cu (bf16/fp32 latent pools)
// and paged_mla_q8.cu (int8 latent pools with one float32 scale per page),
// which fp32 queries and the shapes ops.mla_route does not give the
// tensor-core route (paged_mla_tc.cuh) take.
//
// q_abs (B, H, r), q_rope (B, H, dr); pool_ckv (P, ps, r), pool_krope
// (P, ps, dr); bt (B, bt_cols) int32 page ids; pos (B,) int32 -> out
// (B, H, r) in q's type.  Entry j of request b's chain is
// pool[bt[b, j / ps], j % ps] and holds position j (latent pages index
// globally: no window).  Per entry s = (q_abs . ckv + q_rope . krope) *
// scale, masked unless j <= pos and j < length; out = softmax(s) @ ckv.
//
// Design.  At the full width (H 128, r 512) one block cannot hold every
// head's q row and fp32 accumulator (2 * 128 * 512 * 4 B = 512 KB against
// 227 KB of shared memory), so the heads are tiled, kHeads to a block.
// A request's live pages (those with p*ps <= pos and p*ps < length) are
// cut into n_split contiguous ranges, and split_kernel runs one block per
// (head group, request, range): 512 blocks at 4 slots, 128 heads and 66
// pages (the wrapper sizes n_split for four blocks an SM; 168 registers a
// thread let three be resident), where the 64 (request, head group)
// blocks alone would leave half the SMs idle.  Per page the block stages
// the ckv and krope rows in shared memory as fp32 (int8 codes times the
// page's scale), its 16-byte loads all in flight before any is used; each (head, entry) score is one float4 dot over r
// and one over dr (rows padded by four floats, so the threads of a warp
// read distinct banks); one thread per head updates (m, l) and turns the
// scores into weights; every thread keeps the kHeads x 4 accumulators of
// its four latent columns in registers and adds weights @ ckv reading
// each staged ckv value once.  Every page a range visits holds at least
// one unmasked entry, which keeps its online softmax sound.  The block
// writes its range's unnormalized accumulator and (m, l) to scratch;
// combine_kernel, one block per (head, request), rescales the ranges to
// their common max and writes acc / max(l, 1e-30).  Scores, softmax and
// sums are fp32, as in the TPU kernel; the summation order differs from
// the plain version's (one global max, einsum order), so the two agree
// to ~1e-7, not bit for bit.
//
// Bound: bytes.  The live latent rows are read once (pages * ps * (r + dr)
// elements per request) plus q and out; the flops are
// 2 * B * H * T * (2r + dr), which the tensor cores would finish in less
// time than the bytes take.  This version runs the dots on the CUDA cores
// and reads every page once per head group (H / kHeads times, from L2
// after the first: a request's latent chain is ~1.2 MB at 1056
// positions), and its ranges' partial sums (B * H * n_split * r fp32)
// make a round trip through memory.  The tc route (paged_mla_tc.cuh)
// reads each page once per 64 heads and runs the dots on wgmma; this route
// stays for fp32 queries and the shapes the tc route does not take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_common.cuh"

namespace paged_mla {

using paged_common::store_f;
using paged_common::to_f;
using paged_common::Vec;

constexpr int kHeads = 8;      // query heads per block (ops.MLA_HEADS_PER_BLOCK)
constexpr int kThreads = 128;
constexpr int kPad = 4;        // floats of padding per staged row
constexpr int kBatch = 8;      // 16-byte loads a thread keeps in flight
constexpr float kNegInf = -1e30f;

// Stage one page's rows x cols values of src (row-major, contiguous) into
// dst (row stride ld floats) as fp32 times mul.  vec: the page is 16-byte
// aligned and cols a multiple of Vec<T>::n; then each thread starts up to
// kBatch 16-byte loads before it converts and stores any of them.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int rows, int cols, float mul,
                                      bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int V = Vec<T>::n;
    const int cv = cols / V, n = rows * cv;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int base = 0; base < n; base += kThreads * kBatch) {
      uint4 buf[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + tid;
        if (i < n) buf[j] = __ldg(s4 + i);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + tid;
        if (i < n) {
          const int t = i / cv, c = (i - t * cv) * V;
          float v[V];
          Vec<T>::unpack(buf[j], v);
          float* o = dst + t * ld + c;
#pragma unroll
          for (int k = 0; k < V; k += 4) {
            *reinterpret_cast<float4*>(o + k) = make_float4(
                v[k] * mul, v[k + 1] * mul, v[k + 2] * mul, v[k + 3] * mul);
          }
        }
      }
    }
  } else {
    const int n = rows * cols;
    for (int base = 0; base < n; base += kThreads * kBatch) {
      float buf[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + tid;
        buf[j] = i < n ? to_f(src[i]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + tid;
        if (i < n) {
          const int t = i / cols;
          dst[t * ld + (i - t * cols)] = buf[j] * mul;
        }
      }
    }
  }
}

// Dot of two fp32 rows of length n (a multiple of 4, 16-byte aligned) in
// shared memory: four partial sums, one per float4 lane.
__device__ __forceinline__ float dot4(const float* a, const float* c, int n) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int d = 0; d < n; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(c + d);
    s.x = fmaf(x.x, y.x, s.x);
    s.y = fmaf(x.y, y.y, s.y);
    s.z = fmaf(x.z, y.z, s.z);
    s.w = fmaf(x.w, y.w, s.w);
  }
  return (s.x + s.y) + (s.z + s.w);
}

// Latent columns a thread owns, four at a time (r <= 4 * kThreads * kCols).
constexpr int kCols = 2;

// kScaled: multiply each page's rows by ckv/krope_scale[page] (int8).
// Grid (ceil(H / kHeads), B, n_split); writes the range's unnormalized
// accumulator part_acc[b, h, s, :] and part_ml[b, h, s] = (m, l).
template <typename TQ, typename TKV, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const TQ* __restrict__ q_abs, const TQ* __restrict__ q_rope,
                 const TKV* __restrict__ pool_ckv,
                 const TKV* __restrict__ pool_krope,
                 const float* __restrict__ ckv_scale,
                 const float* __restrict__ krope_scale,
                 const int* __restrict__ bt, const int* __restrict__ pos_b,
                 float* __restrict__ part_acc, float2* __restrict__ part_ml,
                 int H, int r, int dr, int ps, int bt_cols, int length,
                 int n_split, int vec, float scale) {
  extern __shared__ float smem[];
  const int h0 = blockIdx.x * kHeads;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int nh = min(kHeads, H - h0);   // heads of this block
  const int rs = r + kPad, ds = dr + kPad;
  float* qa = smem;                     // kHeads * rs
  float* qr = qa + kHeads * rs;         // kHeads * ds
  float* ck = qr + kHeads * ds;         // ps * rs
  float* kr = ck + ps * rs;             // ps * ds
  float* sc = kr + ps * ds;             // kHeads * ps
  float* m = sc + kHeads * ps;          // kHeads
  float* l = m + kHeads;                // kHeads
  float* alpha = l + kHeads;            // kHeads

  const int pos = pos_b[b];
  const int64_t row0 = static_cast<int64_t>(b) * H + h0;
  for (int g = 0; g < kHeads; ++g) {
    for (int d = tid; d < r; d += kThreads) {
      qa[g * rs + d] = g < nh ? to_f(q_abs[(row0 + g) * r + d]) : 0.0f;
    }
    for (int d = tid; d < dr; d += kThreads) {
      qr[g * ds + d] = g < nh ? to_f(q_rope[(row0 + g) * dr + d]) : 0.0f;
    }
  }
  if (tid < kHeads) {
    m[tid] = kNegInf;
    l[tid] = 0.0f;
  }
  float acc[kHeads][kCols][4];
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[g][c][k] = 0.0f;

  // this range of the request's live pages
  const int n_pages = (length + ps - 1) / ps;
  const int n_live = pos < 0 ? 0 : min(n_pages, pos / ps + 1);
  const int per = (n_pages + n_split - 1) / n_split;
  const int p_end = min(n_live, (split + 1) * per);
  for (int p = split * per; p < p_end; ++p) {
    const int64_t page = bt[static_cast<int64_t>(b) * bt_cols + p];
    float cmul = 1.0f, rmul = 1.0f;
    if (kScaled) {
      cmul = ckv_scale[page];
      rmul = krope_scale[page];
    }
    __syncthreads();  // the previous page's readers are done
    stage(ck, rs, pool_ckv + page * ps * r, ps, r, cmul, vec != 0);
    stage(kr, ds, pool_krope + page * ps * dr, ps, dr, rmul, vec != 0);
    __syncthreads();
    for (int i = tid; i < kHeads * ps; i += kThreads) {
      const int g = i / ps, t = i - g * ps;
      const float s = dot4(qa + g * rs, ck + t * rs, r)
                      + dot4(qr + g * ds, kr + t * ds, dr);
      const int j = p * ps + t;
      const float mask = (j < length && j <= pos) ? 0.0f : kNegInf;
      sc[i] = s * scale + mask;
    }
    __syncthreads();
    if (tid < kHeads) {
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
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = (c * kThreads + tid) * 4;
      if (d >= r) break;
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float a = alpha[g];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[g][c][k] *= a;
      }
      for (int t = 0; t < ps; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(ck + t * rs + d);
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          const float w = sc[g * ps + t];
          acc[g][c][0] = fmaf(w, v.x, acc[g][c][0]);
          acc[g][c][1] = fmaf(w, v.y, acc[g][c][1]);
          acc[g][c][2] = fmaf(w, v.z, acc[g][c][2]);
          acc[g][c][3] = fmaf(w, v.w, acc[g][c][3]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {   // unrolled: acc stays in registers
    if (g >= nh) break;
    const int64_t prow = (row0 + g) * n_split + split;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = (c * kThreads + tid) * 4;
      if (d < r) {
        *reinterpret_cast<float4*>(part_acc + prow * r + d) = make_float4(
            acc[g][c][0], acc[g][c][1], acc[g][c][2], acc[g][c][3]);
      }
    }
    if (tid == 0) part_ml[prow] = make_float2(m[g], l[g]);
  }
}

// One block per (head, request): the ranges' partial sums rescaled to
// their common max, acc / max(l, 1e-30) in q's type.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part_acc,
                   const float2* __restrict__ part_ml, TQ* __restrict__ out,
                   int H, int r, int n_split) {
  const int64_t row = static_cast<int64_t>(blockIdx.y) * H + blockIdx.x;
  const float2* ml = part_ml + row * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[s].x);
  float l = 0.0f;
  for (int s = 0; s < n_split; ++s) l += expf(ml[s].x - mx) * ml[s].y;
  const float lg = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < r; d += kThreads) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      a = fmaf(expf(ml[s].x - mx), part_acc[(row * n_split + s) * r + d], a);
    }
    store_f(out + row * r + d, a / lg);
  }
}

template <typename TQ, typename TKV, bool kScaled>
int launch(const void* q_abs, const void* q_rope, const void* pool_ckv,
           const void* pool_krope, const void* ckv_scale,
           const void* krope_scale, const void* bt, const void* pos,
           void* part_acc, void* part_ml, void* out, int B, int H, int r,
           int dr, int ps, int bt_cols, int length, int n_split, int vec,
           int smem, float scale, void* stream) {
  auto kernel = split_kernel<TQ, TKV, kScaled>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + kHeads - 1) / kHeads, B, n_split);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q_abs), static_cast<const TQ*>(q_rope),
      static_cast<const TKV*>(pool_ckv), static_cast<const TKV*>(pool_krope),
      static_cast<const float*>(ckv_scale),
      static_cast<const float*>(krope_scale), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<float*>(part_acc),
      static_cast<float2*>(part_ml), H, r, dr, ps, bt_cols, length, n_split,
      vec, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<TQ><<<dim3(H, B), kThreads, 0, st>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float2*>(part_ml), static_cast<TQ*>(out), H, r,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged_mla
