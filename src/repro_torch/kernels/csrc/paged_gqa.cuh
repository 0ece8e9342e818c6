// One-token grouped-query attention decode read through a block table:
// the body shared by paged_gqa.cu (bf16/fp32 pools) and paged_gqa_q8.cu
// (int8 pools with one float32 scale per (page, kv head)).  Replaces the
// TPU kernels paged_gqa_fwd and paged_gqa_fwd_q8
// (src/repro/kernels/paged_attention/paged_attention.py:107 and :179).
//
// q (B, H, hd); pools (P, ps, KV, hd); bt (B, bt_cols) int32 page ids;
// pos (B,) int32 -> out (B, H, hd) in q's type.  Query head h reads kv
// head h / G (G = H / KV).  Entry j of request b's chain is
// pool[bt[b, j / ps], j % ps]; with a window the chain is a ring of
// `length` entries and entry j holds position pos - ((pos - j) mod length).
//
// Bound: bytes.  A call reads each live page of every (request, kv head)
// once, 2 * ps * hd elements, plus q and out; the flops, 4 * B * H * T *
// hd, are about 1/300 of what those bytes would allow.  G query rows
// share a kv head (3 at smollm-360m, 2 at gemma3-4b), which would fill
// 3/64 of a wgmma tile, so the dots stay on the CUDA cores on purpose.
//
// Design: one launch, one thread-block cluster per (kv head, query-row
// tile, request).  What it does about the first version's five faults:
//  1. Too few blocks (B * KV): the grid is (n_split, KV * n_gt, B) with a
//     cluster of (n_split, 1, 1).  Each CTA of a cluster takes one
//     contiguous range of the request's live pages (p * ps <= pos and
//     p * ps < length), computed here from the request's own pos, so the
//     wrapper never reads pos and the call can be captured in a CUDA
//     graph.  n_split (ops.gqa_splits, the one layout argument the wrapper
//     passes: a page for each of a CTA's 4 warps on a full chain, at most
//     the portable cluster size 8) depends on length and ps only, never on
//     B, so a request's output is bitwise the same whatever batch it
//     shares; the merges run in a fixed order with no atomics.  A range
//     is empty or begins with a live page, so every page a range visits
//     holds an unmasked entry and its online softmax is sound; an empty
//     range contributes (m = -1e30, l = 0) and the merge skips it.
//  2. A serial page walk with four block barriers a page: warp w of a CTA
//     takes pages w, w + 4, ... of its range and keeps its own (m, l) per
//     query row and its share of the accumulator in registers; no
//     block-wide barrier runs per page.  Warps merge through shared
//     memory, then the CTAs through distributed shared memory: each writes
//     its (m, l, acc) into rank 0's shared memory, and after one cluster
//     barrier rank 0 rescales the ranges to their common max and writes
//     acc / max(l, 1e-30).  Nothing goes through device memory and there
//     is no second kernel.
//  3. 2-byte scalar loads with no loads in flight across pages: a page's
//     K and V rows arrive in 16-byte cp.async copies into a per-warp ring
//     of 1-3 page slots (as many as fit 40 KB a CTA, so that several CTAs
//     share an SM), the next pages' copies issued before the current
//     page's math, and the chain's first 128 page ids are fetched beside
//     pos.  A lane reads rows and scales that other lanes copied (the
//     scales lane 0 copies, rows past the page), so a __syncwarp before
//     each copy ends every lane's reads of the slot it overwrites, and one
//     after the wait makes the copies visible to the warp.  The first
//     costs 2-6 % on the H100; lanes that read only their own copies, or
//     one barrier with the copy issued after it, were no faster (PERF.md).
//     Every row that is a whole count of 16-byte chunks takes them, the
//     int8 scales 4-byte cp.async copies beside them; only a head dim that
//     is not (hd % 8 for bf16) or a pool base that is not 16-byte aligned
//     takes one element a lane, copied synchronously.
//  4. Few threads on the scores: a row's nc chunks lie across `lpr` lanes,
//     32 / lpr rows a pass of the warp.  Where nc is a power of two up to
//     32, lpr = nc and a lane holds one chunk (8 lanes for bf16 at hd 64);
//     otherwise lpr is the fewest lanes that hold at most 8 fp32 values
//     of a row each (or one chunk, int8) and a lane holds ceil(nc / lpr)
//     chunks, those past the row masked: bf16 at hd 160 is 20 chunks over
//     32 lanes, one row a pass; int8 at hd 160 is 10 chunks over 16
//     lanes.  A lane takes 4 of its rows a step (2 for int8): their loads,
//     dots and shuffle reductions over the row's lanes are independent and
//     overlap, and a row past the page reads the page's last row and
//     weighs nothing (score -inf), so a step has no branch.
//  5. A serial softmax: each step's max is a shuffle reduction over the
//     warp, the weights exp2f of scores prescaled by log2(e) / sqrt(hd),
//     and the mask is computed only on pages that can hold a masked entry
//     (the last live page; every page when a ring is longer than its
//     window).
// Each lane keeps kG query rows (the tile) of its columns in registers (q
// and acc: 2 * kG * 8 fp32 values, 2 * kG * 16 on int8 pages); all G rows
// of a kv head are one tile up to 4 (int8: 3; one-element rows: 1), so a
// page is read once for each (request, kv head) where G fits
// (stablelm-12b's G 4 on bf16 pages); a larger G is cut into equal tiles
// across clusters, each reading the pages again (mistral-large-123b's 12:
// three; stablelm's int8 pages: two of 2).  choose_layout() picks that
// layout (chunks, lanes a row, tile rows) from the shape and the pools'
// alignment, launch() the ring stages.  int8 codes become fp32 in two
// full-rate operations each and are multiplied by their page's scale in
// registers before the dots, so the dots see exactly codes * scale, as
// the plain version's dequantized pools hold.  Scores, softmax and sums
// are fp32, as in the TPU kernel; the summation order differs from the
// plain version's (one global max), so the two agree to ~1e-7, not bit
// for bit.
//
// What bounds it now, on the H100 (PERF.md): at decode shapes the chain
// of dependent steps of each CTA, not the bytes.  At stablelm-12b's
// 4-slot decode (a page or two a warp) a CTA lives about 17 us: 3.4 to
// its first page (pos and page ids, then the page), 6.2 on its pages and
// 7.5 in the cluster's merge, which waits for the cluster's last CTA; all
// 256 CTAs are resident at once.  On long chains the per-page arithmetic
// of a warp, not the bytes, for int8 pages (half the bytes of bf16 for the
// same work a page).  Lanes that hold 16 values of a bf16 row (20 chunks
// over 16 lanes) need 205-210 registers, which leave two CTAs an SM and a
// second wave: 1.5-1.6x slower than 8 values over 32 lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_common.cuh"

namespace paged_gqa {

using paged_common::store_f;
using paged_common::to_f;
using paged_common::Vec;

constexpr int kWarps = 4;              // ops.GQA_WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;           // ops.GQA_MAX_SPLIT
constexpr int kMaxHd = 256;
// bytes the warps' rings may take: as many slots a warp (at most three) as
// fit, at least one, so that several CTAs share an SM
constexpr int kRingBytes = 40960;
constexpr size_t kSmemLimit = 232448;  // opt-in shared memory of an H100
constexpr float kNegInf = -1e30f;
constexpr int kIdRegs = 4;             // page ids a lane fetches (x 32)

#ifdef PAGED_GQA_TRACE
// A CTA's timeline, for launch/profile.py: globaltimer (ns) at its start,
// when warp 0's first page has landed, when warp 0 is done with its pages
// and after the merge's cluster barrier, then its SM.  Built only with
// -DPAGED_GQA_TRACE; the kernels of the package carry none of it.
constexpr int kTraceCtas = 1 << 16;
__device__ unsigned long long g_trace[kTraceCtas * 5];
__device__ __forceinline__ void mark(int i) {
  const unsigned cta =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (cta < kTraceCtas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[cta * 5 + i] = t;
    if (i == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      g_trace[cta * 5 + 4] = sm;
    }
  }
}
#define GQA_MARK(i) \
  if (threadIdx.x == 0) paged_gqa::mark(i)
#else
#define GQA_MARK(i)
#endif

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n (0-2) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// Address of this CTA's shared `p` in the shared memory of CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// The fp32 values of a 16-byte vector of page data.  int8 codes take two
// full-rate operations each: the code's byte plus 128 becomes the low byte
// of the float 2^23 + (c + 128), from which 2^23 + 128 is subtracted
// (exactly), in place of a conversion instruction at a quarter of the rate.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* o) {
  Vec<T>::unpack(u, o);
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& u, float* o) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[4 * i + k] =
          __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u + k)) -
          8388736.0f;
    }
  }
}

// The unit of a row one lane copies and reads.  kCL > 0: 16-byte vectors
// of TKV, kCL of them a lane (chunks lc, lc + lpr, ...; those past the
// row's nc are masked); kCL == 0: one element at a time, up to kMaxHd / 32
// a lane and one row a pass of the warp, where 16-byte copies cannot
// address the pools.
template <typename TKV, int kCL> struct Chunk {
  static constexpr int n = Vec<TKV>::n;
  static constexpr int per_lane = kCL;
  __device__ static void stage(TKV* dst, const TKV* src) {
    cp_async16(dst, src);
  }
  __device__ static void load(const TKV* s, float* o) {
    unpack16<TKV>(*reinterpret_cast<const uint4*>(s), o);
  }
};
template <typename TKV> struct Chunk<TKV, 0> {
  static constexpr int n = 1;
  static constexpr int per_lane = kMaxHd / 32;
  __device__ static void stage(TKV* dst, const TKV* src) { *dst = *src; }
  __device__ static void load(const TKV* s, float* o) { o[0] = to_f(*s); }
};

struct Params {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int* bt;
  const int* pos;
  void* out;
  int H, KV, G, hd, ps, bt_cols, length, window;
  int n_split;     // CTAs of a cluster: page ranges of one request
  int n_gt;        // query-row tiles of a kv head
  int stages;      // page slots of a warp's ring (1-3)
  int lpr;         // lanes a row's chunks lie across (a power of two)
  int slot_bytes;  // K page, V page, their two scales; 16-byte multiple
  float scale2;    // log2(e) / sqrt(hd)
};

// Bytes of one ring slot: K and V page rows of this kv head, then the two
// page scales, each part 16-byte aligned.
__host__ __device__ inline int slot_bytes(int ps, int hd, int elem) {
  return (2 * ps * hd * elem + 15) / 16 * 16 + 16;
}

// Dynamic shared memory of one CTA: the warps' rings, then the warps'
// partials and the cluster's partials (n_split, read by rank 0), each
// partial m[kG], l[kG], acc[kG][hd] in fp32.
inline size_t smem_bytes(int ps, int hd, int elem, int kG, int n_split,
                         int stages) {
  return static_cast<size_t>(kWarps) * stages * slot_bytes(ps, hd, elem) +
         4 * static_cast<size_t>((kWarps + n_split) * kG * (hd + 2));
}

// Where a lane works in a page: rows rg + rpi * i (i < rpl), chunks
// lc + lpr * j (j < Chunk::per_lane, those below nc).
struct Lane {
  int lane, lc, rg, lpr, rpi, rpl, nc;
};

// Id of chain page `pg` (warp-uniform): from the ids the warp fetched up
// front (lane i holds ids i, i + 32, ...) while pg < 32 * kIdRegs, else
// from the block table.
__device__ __forceinline__ int64_t page_id(const int (&idr)[kIdRegs],
                                           int pg, const int* btr) {
  if (pg >= 32 * kIdRegs) return btr[pg];
  int v = idr[0];
#pragma unroll
  for (int j = 1; j < kIdRegs; ++j) v = (pg >> 5) == j ? idr[j] : v;
  return __shfl_sync(0xffffffffu, v, pg & 31);
}

// Start the copies of page `id`'s K and V rows of kv head `kv` into a ring
// slot, each lane the chunks it reads later; lane 0 also copies the page's
// two scales (int8 pools).
template <typename TKV, bool kScaled, int kCL, bool kMask>
__device__ __forceinline__ void stage_page(unsigned char* slot,
                                           const Params& p, const Lane& L,
                                           int64_t id, int kv, int sc_off) {
  using C = Chunk<TKV, kCL>;
  const TKV* PK = static_cast<const TKV*>(p.pool_k);
  const TKV* PV = static_cast<const TKV*>(p.pool_v);
  TKV* sk = reinterpret_cast<TKV*>(slot);
  TKV* sv = sk + p.ps * p.hd;
  for (int i = 0; i < L.rpl; ++i) {
    const int rr = L.rg + L.rpi * i;
    if (rr >= p.ps) break;
    const int64_t row = ((id * p.ps + rr) * p.KV + kv) * p.hd;
#pragma unroll
    for (int j = 0; j < C::per_lane; ++j) {
      const int c = L.lc + L.lpr * j;
      if ((kCL > 0 && !kMask) || c < L.nc) {
        C::stage(sk + rr * p.hd + c * C::n, PK + row + c * C::n);
        C::stage(sv + rr * p.hd + c * C::n, PV + row + c * C::n);
      }
    }
  }
  if (kScaled && L.lane == 0) {
    float* ss = reinterpret_cast<float*>(slot + sc_off);
    const int64_t si = id * p.KV + kv;
    if (kCL > 0) {
      cp_async4(ss, p.k_scale + si);
      cp_async4(ss + 1, p.v_scale + si);
    } else {
      ss[0] = p.k_scale[si];
      ss[1] = p.v_scale[si];
    }
  }
}

// Chunk j of a lane in the dots: false where the lane reads none; c
// becomes the chunk it reads.  One element a lane skips what passes the
// row.  A masked 16-byte layout (kMask: nc not a power of two) skips a
// chunk that no lane of the warp holds and otherwise reads the row's last
// chunk in place of one past the row, so the dots do not branch: q is zero
// there, and acc there is never stored.
template <int kCL, bool kMask>
__device__ __forceinline__ bool dot_chunk(const Lane& L, int j, int& c) {
  c = L.lc + L.lpr * j;
  if (kCL == 0) return c < L.nc;
  if (!kMask) return true;
  c = min(c, L.nc - 1);
  return L.lpr * j < L.nc;
}

// kScaled: multiply each page's rows by ks/vs[page * KV + kv] (int8 pools).
// kCL, kMask: the layout (Chunk, dot_chunk).  kG: query rows of a tile (the
// last tile may hold fewer).  Bounded for one CTA an SM, the build whose
// registers and times PERF.md records (the bare bound gives the
// one-element layout 80 / 72 registers in place of 116 / 96).
template <typename TQ, typename TKV, bool kScaled, int kCL, bool kMask,
          int kG>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const Params p) {
  using C = Chunk<TKV, kCL>;
  constexpr int kN = C::n;
  constexpr int kE = C::n * C::per_lane;  // elements of a row a lane holds
  // rows a lane scores and weighs per step: their loads, dots and
  // shuffles are independent, so they overlap
  constexpr int kRB = kN >= 16 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const TQ* __restrict__ Q = static_cast<const TQ*>(p.q);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rank = blockIdx.x;  // the cluster spans grid x: x is the rank
  const int kv = blockIdx.y / p.n_gt;
  const int g0 = (blockIdx.y - kv * p.n_gt) * kG;
  const int gt = min(kG, p.G - g0);
  const int b = blockIdx.z;
  const int hd = p.hd, ps = p.ps;
  const int pf = kG * (hd + 2);  // floats of one partial

  // phase 1 of the cluster barrier: every CTA has started before any
  // writes into rank 0's shared memory
  cluster_arrive_relaxed();
  GQA_MARK(0);

  // the chain's first kIdRegs * 32 page ids come in beside pos, so the
  // first page copy waits on one round trip, not two
  const int* btr = p.bt + static_cast<int64_t>(b) * p.bt_cols;
  const int n_pages = (p.length + ps - 1) / ps;
  int idr[kIdRegs];
#pragma unroll
  for (int j = 0; j < kIdRegs; ++j) {
    const int c = lane + 32 * j;
    idr[j] = c < n_pages ? btr[c] : 0;
  }
  const int pos = p.pos[b];
  const int n_live = pos < 0 ? 0 : min(pos, p.length - 1) / ps + 1;
  const int begin = rank * n_live / p.n_split;
  const int end = (rank + 1) * n_live / p.n_split;

  unsigned char* ring = smem + w * p.stages * p.slot_bytes;
  float* wparts =
      reinterpret_cast<float*>(smem + kWarps * p.stages * p.slot_bytes);
  float* cparts = wparts + kWarps * pf;

  Lane L;
  L.lane = lane;
  L.nc = hd / kN;
  L.lpr = p.lpr;
  L.rpi = 32 / L.lpr;
  L.lc = lane & (L.lpr - 1);
  L.rg = lane / L.lpr;
  L.rpl = (ps + L.rpi - 1) / L.rpi;

  if (begin < end) {
    float q[kG][kE], acc[kG][kE], m[kG], l[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = kNegInf;
      l[g] = 0.0f;
      const TQ* qr = Q + (static_cast<int64_t>(b) * p.H + kv * p.G + g0 + g)
                             * hd;
#pragma unroll
      for (int j = 0; j < C::per_lane; ++j) {
        const int c = L.lc + L.lpr * j;
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          q[g][j * kN + e] =
              (g < gt && c < L.nc) ? to_f(qr[c * kN + e]) : 0.0f;
          acc[g][j * kN + e] = 0.0f;
        }
      }
    }
    // pages first, first + kWarps, ... of the range are this warp's
    const int first = begin + w;
    const int n_mine = first < end ? (end - first + kWarps - 1) / kWarps : 0;
    const int sc_off = slot_bytes(ps, hd, sizeof(TKV)) - 16;
    const bool mask_all = p.window >= 0 && p.length > p.window;

    int wr = 0;  // ring slot the next copy goes to
    for (int k = 0; k < p.stages - 1; ++k) {
      if (k < n_mine) {
        stage_page<TKV, kScaled, kCL, kMask>(
            ring + wr * p.slot_bytes, p, L,
            page_id(idr, first + k * kWarps, btr), kv, sc_off);
      }
      cp_async_commit();
      wr = wr + 1 == p.stages ? 0 : wr + 1;
    }
    int rd = 0;  // ring slot of page k
    for (int k = 0; k < n_mine; ++k) {
      // every lane is done with the slot the next copy overwrites (read
      // for page k - 1)
      __syncwarp();
      const int kn = k + p.stages - 1;
      if (kn < n_mine) {
        stage_page<TKV, kScaled, kCL, kMask>(
            ring + wr * p.slot_bytes, p, L,
            page_id(idr, first + kn * kWarps, btr), kv, sc_off);
      }
      cp_async_commit();
      wr = wr + 1 == p.stages ? 0 : wr + 1;
      cp_async_wait(p.stages - 1);
      __syncwarp();
      if (k == 0) GQA_MARK(1);
      const unsigned char* slot = ring + rd * p.slot_bytes;
      rd = rd + 1 == p.stages ? 0 : rd + 1;
      const TKV* sk = reinterpret_cast<const TKV*>(slot);
      const TKV* sv = sk + ps * hd;
      float kmul = 1.0f, vmul = 1.0f;
      if (kScaled) {
        const float* ss = reinterpret_cast<const float*>(slot + sc_off);
        kmul = ss[0];
        vmul = ss[1];
      }
      const int pg = first + k * kWarps;
      const bool masked = mask_all || pg == n_live - 1;
      for (int i0 = 0; i0 < L.rpl; i0 += kRB) {
        // this step's rows; a row past the page reads the page's last row
        // and weighs nothing (score -inf)
        int row[kRB];
        bool live[kRB];
#pragma unroll
        for (int u = 0; u < kRB; ++u) {
          const int rr = L.rg + L.rpi * (i0 + u);
          live[u] = rr < ps;
          row[u] = min(rr, ps - 1);
        }
        float s[kRB][kG];
#pragma unroll
        for (int u = 0; u < kRB; ++u) {
#pragma unroll
          for (int g = 0; g < kG; ++g) s[u][g] = 0.0f;
#pragma unroll
          for (int j = 0; j < C::per_lane; ++j) {
            int c;
            if (dot_chunk<kCL, kMask>(L, j, c)) {
              float kx[kN];
              C::load(sk + row[u] * hd + c * kN, kx);
#pragma unroll
              for (int e = 0; e < kN; ++e) {
                if (kScaled) kx[e] *= kmul;
#pragma unroll
                for (int g = 0; g < kG; ++g) {
                  s[u][g] = fmaf(q[g][j * kN + e], kx[e], s[u][g]);
                }
              }
            }
          }
        }
        for (int o = 1; o < L.lpr; o <<= 1) {
#pragma unroll
          for (int u = 0; u < kRB; ++u) {
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
            }
          }
        }
        float mx[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) mx[g] = kNegInf;
#pragma unroll
        for (int u = 0; u < kRB; ++u) {
          const float mk =
              masked ? entry_mask(pg * ps + row[u], pos, p.length, p.window)
                     : 0.0f;
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            s[u][g] = live[u] ? fmaf(s[u][g], p.scale2, mk) : -INFINITY;
            mx[g] = fmaxf(mx[g], s[u][g]);
          }
        }
        // the step's max over the warp; rescale, then weigh the rows
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          for (int o = L.lpr; o < 32; o <<= 1) {
            mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
          }
          const float m_new = fmaxf(m[g], mx[g]);
          const float alpha = exp2f(m[g] - m_new);
          m[g] = m_new;
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
        }
#pragma unroll
        for (int u = 0; u < kRB; ++u) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            s[u][g] = exp2f(s[u][g] - m[g]);
            l[g] += s[u][g];
          }
#pragma unroll
          for (int j = 0; j < C::per_lane; ++j) {
            int c;
            if (dot_chunk<kCL, kMask>(L, j, c)) {
              float vx[kN];
              C::load(sv + row[u] * hd + c * kN, vx);
#pragma unroll
              for (int e = 0; e < kN; ++e) {
                if (kScaled) vx[e] *= vmul;
#pragma unroll
                for (int g = 0; g < kG; ++g) {
                  acc[g][j * kN + e] =
                      fmaf(s[u][g], vx[e], acc[g][j * kN + e]);
                }
              }
            }
          }
        }
      }
    }
    // fold the row groups (l and acc so far sum this lane's rows only),
    // then this warp's partial to shared memory
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      for (int o = L.lpr; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        }
      }
    }
    float* wp = wparts + w * pf;
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        wp[g] = m[g];
        wp[kG + g] = l[g];
      }
    }
    if (L.rg == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int j = 0; j < C::per_lane; ++j) {
          const int c = L.lc + L.lpr * j;
          if (c < L.nc) {
#pragma unroll
            for (int e = 0; e < kN; ++e) {
              wp[2 * kG + g * hd + c * kN + e] = acc[g][j * kN + e];
            }
          }
        }
      }
    }
  }
  GQA_MARK(2);
  __syncthreads();
  cluster_wait();  // every CTA of the cluster has started
  if (begin < end) {
    // merge the warps (a warp with no page holds m = -1e30, l = 0) into
    // this range's partial, written into rank 0's slot `rank`
    const uint32_t dst = map_rank(cparts + rank * pf, 0);
    for (int t = threadIdx.x; t < kG * (hd + 1); t += kThreads) {
      const int g = t < kG ? t : (t - kG) / hd;
      float mw[kWarps], mg = kNegInf;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        mw[v] = wparts[v * pf + g];
        mg = fmaxf(mg, mw[v]);
      }
      float sum = 0.0f;
      if (t < kG) {
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          sum += exp2f(mw[v] - mg) * wparts[v * pf + kG + g];
        }
        st_cluster(dst + 4 * g, mg);
        st_cluster(dst + 4 * (kG + g), sum);
      } else {
        const int i = 2 * kG + (t - kG);  // acc[g][d]
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          sum += exp2f(mw[v] - mg) * wparts[v * pf + i];
        }
        st_cluster(dst + 4 * i, sum);
      }
    }
  }
  cluster_arrive_release();
  cluster_wait();
  GQA_MARK(3);
  if (rank == 0) {
    // the ranks whose ranges hold pages, merged in rank order
    unsigned filled = 0;
    for (int r = 0; r < p.n_split; ++r) {
      if (r * n_live / p.n_split < (r + 1) * n_live / p.n_split) {
        filled |= 1u << r;
      }
    }
    TQ* out = static_cast<TQ*>(p.out);
    for (int t = threadIdx.x; t < gt * hd; t += kThreads) {
      const int g = t / hd;
      float mg = kNegInf;
      for (unsigned f = filled; f; f &= f - 1) {
        mg = fmaxf(mg, cparts[(__ffs(f) - 1) * pf + g]);
      }
      float a = 0.0f, lg = 0.0f;
      for (unsigned f = filled; f; f &= f - 1) {
        const float* cp = cparts + (__ffs(f) - 1) * pf;
        const float sc = exp2f(cp[g] - mg);
        lg += sc * cp[kG + g];
        a += sc * cp[2 * kG + t];
      }
      const int64_t orow = static_cast<int64_t>(b) * p.H + kv * p.G + g0 + g;
      store_f(out + orow * hd + (t - g * hd), a / fmaxf(lg, 1e-30f));
    }
  }
}

template <typename TQ, typename TKV, bool kScaled, int kCL, bool kMask,
          int kG>
cudaError_t launch_tile(const Params& p, int B, cudaStream_t stream) {
  auto kernel = decode_kernel<TQ, TKV, kScaled, kCL, kMask, kG>;
  const size_t smem = smem_bytes(p.ps, p.hd, sizeof(TKV), kG, p.n_split,
                                 p.stages);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_split, p.KV * p.n_gt, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// decode_kernel at the tile rows gt (at most kMaxTile) of layout (kCL,
// kMask).
template <typename TQ, typename TKV, bool kScaled, int kCL, bool kMask,
          int kMaxTile>
cudaError_t launch_rows(const Params& p, int gt, int B, cudaStream_t s) {
  constexpr int kTop = kMaxTile > 3 ? 4 : 3;
  if (gt == 1) return launch_tile<TQ, TKV, kScaled, kCL, kMask, 1>(p, B, s);
  if (gt == 2) return launch_tile<TQ, TKV, kScaled, kCL, kMask, 2>(p, B, s);
  if (gt == 3) return launch_tile<TQ, TKV, kScaled, kCL, kMask, 3>(p, B, s);
  return launch_tile<TQ, TKV, kScaled, kCL, kMask, kTop>(p, B, s);
}

// Query rows a tile at most on 16-byte chunks: 4, int8 pages 3 (a 4-row
// int8 tile takes 202 registers at hd 160, two CTAs an SM, and read 24 %
// slower; PERF.md).
template <typename TKV> constexpr int max_tile() {
  return sizeof(TKV) == 1 ? 3 : 4;
}
// Chunks a lane holds at most where a row is not a power-of-two count of
// them: 8 fp32 values of a row (bf16 1, fp32 2) or one chunk (int8).  16
// values a lane (bf16 hd 160: 20 chunks over 16 lanes) take 205 registers,
// which leave a second wave (PERF.md).
template <typename TKV> constexpr int max_chunks() {
  return 8 / Vec<TKV>::n > 1 ? 8 / Vec<TKV>::n : 1;
}
static_assert(kMaxHd / Vec<float>::n <= 32 * max_chunks<float>() &&
                  kMaxHd / Vec<__nv_bfloat16>::n <=
                      32 * max_chunks<__nv_bfloat16>() &&
                  kMaxHd / Vec<int8_t>::n <= 32 * max_chunks<int8_t>(),
              "a row of kMaxHd fits 32 lanes");

// The layout of one launch (ops.gqa_layout mirrors it): lanes a row, chunks
// a lane (0: one element a lane), query-row tiles of a kv head and rows a
// tile.
struct Layout {
  int lpr, cl, n_tiles, gt;
};

// Where hd is a whole count nc of 16-byte chunks and both pools are 16-byte
// aligned, a row's chunks lie across lpr lanes: lpr = nc and one chunk a
// lane where nc is a power of two up to 32, else the fewest lanes (a power
// of two) that hold at most max_chunks() chunks each, the last chunks
// masked; G query rows are cut into equal tiles of at most max_tile() rows.
// Otherwise one element a lane and one query row a tile.
template <typename TKV>
Layout choose_layout(int hd, int G, bool aligned) {
  constexpr int kVecN = Vec<TKV>::n;
  const int nc = hd / kVecN;
  const bool vec = aligned && hd % kVecN == 0;
  Layout L = {32, 0, G, 1};
  if (vec && nc <= 32 && (nc & (nc - 1)) == 0) {
    L.lpr = nc;
    L.cl = 1;
  } else if (vec) {
    L.lpr = 1;
    while ((nc + L.lpr - 1) / L.lpr > max_chunks<TKV>()) L.lpr *= 2;
    L.cl = (nc + L.lpr - 1) / L.lpr;
  }
  if (vec) {
    L.n_tiles = (G + max_tile<TKV>() - 1) / max_tile<TKV>();
    L.gt = (G + L.n_tiles - 1) / L.n_tiles;
  }
  return L;
}

// The layout launch() takes at (hd, G, pools aligned or not), written to
// out[0..3] as (lanes a row, chunks a lane, query-row tiles, rows a tile),
// so that the wrapper's mirror of the rule can be checked against it.
template <typename TKV>
int layout_info(int hd, int G, int aligned, int* out) {
  if (hd < 1 || hd > kMaxHd || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = choose_layout<TKV>(hd, G, aligned != 0);
  out[0] = L.lpr;
  out[1] = L.cl;
  out[2] = L.n_tiles;
  out[3] = L.gt;
  return static_cast<int>(cudaSuccess);
}

// n_split page ranges a request come from ops.gqa_splits; the rest of the
// layout from choose_layout.  Ring stages: the most (3, 2, else 1) within
// kRingBytes.  Returns a cudaError_t as int: cudaErrorInvalidValue for
// arguments or a shared-memory size the kernel does not take.
template <typename TQ, typename TKV, bool kScaled>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* k_scale, const void* v_scale, const void* bt,
           const void* pos, void* out, int B, int H, int KV, int hd, int ps,
           int bt_cols, int length, int window, int n_split, void* stream) {
  constexpr int kMaxCL = max_chunks<TKV>();
  constexpr int kMaxTile = max_tile<TKV>();
  const bool bad = B < 1 || KV < 1 || H % KV || hd < 1 || hd > kMaxHd ||
                   ps < 1 || length < 1 || n_split < 1 ||
                   n_split > kMaxSplit;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const Layout lay = choose_layout<TKV>(
      hd, G, reinterpret_cast<uintptr_t>(pool_k) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(pool_v) % 16 == 0);
  const int nc = hd / Vec<TKV>::n;
  const int gt = lay.gt;
  const int slot = slot_bytes(ps, hd, sizeof(TKV));
  int stages = 3;
  while (stages > 1 && kWarps * stages * slot > kRingBytes) --stages;
  if (smem_bytes(ps, hd, sizeof(TKV), gt, n_split, stages) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(bt);
  p.pos = static_cast<const int*>(pos);
  p.out = out;
  p.H = H;
  p.KV = KV;
  p.G = G;
  p.hd = hd;
  p.ps = ps;
  p.bt_cols = bt_cols;
  p.length = length;
  p.window = window;
  p.n_split = n_split;
  p.n_gt = lay.n_tiles;
  p.stages = stages;
  p.lpr = lay.lpr;
  p.slot_bytes = slot;
  // the reference's 1.0 / (hd ** 0.5) times log2(e), rounded once to fp32
  p.scale2 = static_cast<float>(1.4426950408889634 /
                                sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lay.cl == 0) {
    err = launch_tile<TQ, TKV, kScaled, 0, true, 1>(p, B, s);
  } else if (lay.lpr == nc) {
    err = launch_rows<TQ, TKV, kScaled, 1, false, kMaxTile>(p, gt, B, s);
  } else if (lay.cl == 1) {
    err = launch_rows<TQ, TKV, kScaled, 1, true, kMaxTile>(p, gt, B, s);
  } else {
    // fewer than kMaxCL chunks a lane run the kMaxCL-chunk layout, the
    // rest skipped by the whole warp
    err = launch_rows<TQ, TKV, kScaled, kMaxCL, true, kMaxTile>(p, gt, B,
                                                                 s);
  }
  return static_cast<int>(err);
}

}  // namespace paged_gqa

#ifdef PAGED_GQA_TRACE
// Copy the first n_ctas CTAs' timelines (5 values each) to host memory.
extern "C" int paged_gqa_trace_read(void* host, int n_ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, paged_gqa::g_trace,
      sizeof(unsigned long long) * 5 * static_cast<size_t>(n_ctas)));
}
#endif
