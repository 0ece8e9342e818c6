// Paged weight-absorbed MLA decode on Hopper's tensor cores: the "tc"
// route of paged_mla.cu (bf16 queries over bf16 latent pages) and
// paged_mla_q8.cu (bf16 queries over int8 latent pages with one float32
// scale per page for each pool).  Replaces, with paged_mla.cuh's simt
// route, the TPU kernels paged_mla_fwd and paged_mla_fwd_q8
// (src/repro/kernels/paged_attention/paged_attention.py:259 and :332).
// ops.mla_route picks the route: this one takes r 512, dr 64, pages of 8,
// 16 or 32 entries and 16-byte-aligned operands (deepseek-v3's MLA).
//
// Bound, at the serving path's shape (4 requests, 128 heads, cache 1056,
// page 16): one call moves 5.98 MB with bf16 pages (1.79 us at 3.35 TB/s)
// and does 1.18 GFLOP (1.19 us at the bf16 tensor-core peak), bytes; with
// int8 pages 3.55 MB (1.06 us) for the same operations, so operations.
// Both are near the card's ridge: the 128 query heads of a request share
// one latent, which makes the read a matrix product, not a stream, and
// the CUDA cores (67 TFLOP/s) could not come within 10x of it.
//
// Design.  A CTA of two warpgroups owns 64 query heads of one request
// (one wgmma M tile; rows past H load as zeros and are never stored) over
// one contiguous range of that request's live pages (p * ps <= pos and
// p * ps < length).
//  * Ranges: the wrapper passes only their number, n_split
//    (ops.mla_tc_splits, from the static shape: the CTAs fill the SMs
//    once, a range at most kMaxRange pages).  Each CTA cuts its request's
//    live stages (kTok rows, kTok / ps pages each) into n_split balanced
//    ranges from the request's own pos (the CPU tests model the same
//    rule), so the wrapper never reads pos, the call can be captured in a
//    CUDA graph, and a short request's pages spread over all its ranges.
//    No load is issued for a page past the range's last live page.
//  * Loads: q_abs and q_rope of the 64 heads arrive once by TMA, as one
//    64 x 576 bf16 operand (nine 128-byte-swizzled panels of 64 columns).
//    Pages arrive by TMA from 2-D tensor maps over the pools viewed as
//    (P * ps, r) and (P * ps, dr) into a ring of kStages stages of kTok
//    latent rows.  At H 128 the request's two head tiles read each page
//    (the second read at about the same time, so from L2): multicasting
//    it into a cluster of both tiles read each page once but was 0-3 %
//    slower (PERF.md).  All threads fetch the range's page ids into
//    shared memory up front, so thread 0, which also computes, refills
//    the ring without a global load; int8 scales follow once the first
//    stages are issued.  A stage whose last page slots lie past the range
//    loads its first page into them again, and their entries are masked.
//    int8 codes land unswizzled; all 256 threads widen the next stage to
//    bf16 (exact: |code| <= 127) into one of two swizzled tiles while the
//    scores of the current one run.
//  * Scores: S (64 heads x 32 rows) = Q . [ckv; krope]^T is a chain of 36
//    wgmma m64n32k16 with the stage tile as the K-major B operand, fp32
//    accumulation.  For int8 the ckv and krope parts take two chains, and
//    each column is scaled by its page's ckv_scale and krope_scale before
//    they are added.  Each warpgroup computes S itself (27 % more tensor
//    work than one shared S, and no exchange through shared memory).
//  * Softmax: the online (m, l) of each head row is fp32 in registers
//    (four threads a row), exp as exp2 of a product with log2(e); the
//    running sum is rescaled only where a row of the warp has a new max.
//  * Latent sum: O += P . ckv, the same staged ckv tile read MN-major as
//    B (no transposed copy).  Warpgroup w owns latent columns 256 w ..
//    256 w + 255: a 64 x 256 fp32 running sum, 128 registers a thread.
//    P (fp32; for int8 times the column's page ckv_scale) is split into
//    three bf16 parts in registers (RS wgmma), and each 64-column chunk's
//    product over the stage's 32 rows and three parts is summed in a
//    fresh accumulator (two alternate, so one chunk's products run while
//    the one before is added) and added to the running sum in fp32.
//  * Merge: each CTA writes its range's unnormalized sum and (m, l) to
//    fp32 scratch, and combine_tc (one block per head and request)
//    rescales the ranges to their common max and divides; an empty range
//    writes only (m, l) = (-1e30, 0), which it skips.
//
// What bounds it now (PERF.md): at the path shape latency, not bytes: each
// CTA runs three stages, Q and the first stage arrive before any product,
// the phases of a stage (scores, softmax and split, latent sum) run one
// after another in both warpgroups, and combine_tc is a second launch of
// about a fifth of the call.  On long contexts the per-stage tensor and
// shared-memory work (the scores read Q from shared memory again for
// every 32 rows).
//
// Rounding contract, against the plain version's fp32 computation: a bf16
// x bf16 (or bf16 x int8 code) product is exact in fp32, so the scores
// are fp32 sums of the exact products in another order; the three bf16
// parts of P leave less than 2^-24 |p| unrepresented (flash_tc.cuh,
// kSplit), and the tensor cores only ever sum one stage of one chunk.
// The outputs stay within one bf16 ulp + 2e-6 of the plain version.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "paged_mla.cuh"
#include "sm90.cuh"

namespace paged_mla {
namespace tc {

using namespace ::sm90;
using flash::tc::exp_e;
using flash::tc::keep;
using flash::tc::kSplit;
using flash::tc::Mma;
using flash::tc::quad_max;
using flash::tc::quad_sum;
using flash::tc::split_frag;

constexpr int kR = 512, kDR = 64, kK = kR + kDR;  // latent ranks
constexpr int kHeads = 64;     // query heads of a CTA (ops.MLA_TC_HEADS)
constexpr int kTok = 32;       // latent rows of a stage (ops.MLA_TC_ROWS)
constexpr int kThreads = 256;  // two warpgroups
constexpr int kChunks = kR / 2 / 64;  // 64-column chunks of a warpgroup
constexpr int kStages = 3;
// Most pages a range may hold (ops.MLA_TC_MAX_RANGE): their ids (and int8
// scales) are fetched into shared memory up front, so thread 0, which
// also computes, never waits on the block table when it refills the ring.
constexpr int kMaxRange = 256;
using T = flash::tc::Tile<kK>;  // nine panels of 64 columns

constexpr int kPanelQ = kHeads * 128;     // a panel of Q: 64 rows x 128 B
constexpr int kPanelT = kTok * 128;       // a panel of a stage tile
constexpr int kQBytes = T::NP * kPanelQ;  // 73728
constexpr int kTileBytes = T::NP * kPanelT;  // 36864
// an int8 stage as it lands: ckv [2][32 rows][256], krope [32 rows][64]
constexpr int kRawBytes = kTok * kK;
constexpr int kRawHalf = kTok * 256;

// Q, the ring and (int8) two widened tiles
template <bool kQ8>
struct Layout {
  static constexpr int ring = kQBytes;
  static constexpr int stage = kQ8 ? kRawBytes : kTileBytes;
  static constexpr int wide = ring + kStages * stage;
  static constexpr int smem = wide + (kQ8 ? 2 * kTileBytes : 0) + 1024;
};

struct Params {
  const int* bt;
  const int* pos;
  const float* ckv_scale;
  const float* krope_scale;
  float* part_acc;
  float2* part_ml;
  int H, ps, bt_cols, length, n_split;
  float scale;
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 u;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(addr)
               : "memory");
  return u;
}

// Sixteen int8 codes u into two 16-byte chunks of bf16 at d0 and d1: the
// code's byte plus 128 becomes the low byte of the float 2^23 + (c + 128),
// from which 2^23 + 128 is subtracted (exactly).
__device__ __forceinline__ void widen16(const uint4& u, uint32_t d0,
                                        uint32_t d1) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      const float f0 = __int_as_float(__byte_perm(w[i], 0x4B000000u,
                                                  0x7650u + k)) - 8388736.0f;
      const float f1 = __int_as_float(__byte_perm(w[i], 0x4B000000u,
                                                  0x7651u + k)) - 8388736.0f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
      o[2 * i + k / 2] = *reinterpret_cast<const uint32_t*>(&h);
    }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d0),
               "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3])
               : "memory");
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d1),
               "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7])
               : "memory");
}

// An int8 stage (raw) into a bf16 stage tile.  ckv: thread i takes the
// 16-code chunk i % 32 of rows i / 32 + 8 j (j < 4), so its addresses are
// fixed but for a row offset and a quarter warp reads 128 contiguous
// bytes; krope: threads 0-127 take one chunk each.
__device__ __forceinline__ void widen_stage(uint32_t raw, uint32_t tile,
                                            int tid) {
  const int c = tid % 32, r0 = tid / 32;  // row % 8 == r0 for every j
  const uint32_t src = raw + (c / 16) * kRawHalf + r0 * 256 + (c % 16) * 16;
  const uint32_t row = tile + (c / 4) * kPanelT + r0 * 128;
  const uint32_t d0 = row + (((2 * (c % 4)) ^ r0) << 4);
  const uint32_t d1 = row + (((2 * (c % 4) + 1) ^ r0) << 4);
  uint4 u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) u[j] = lds128(src + j * 8 * 256);
#pragma unroll
  for (int j = 0; j < 4; ++j) widen16(u[j], d0 + j * 8 * 128, d1 + j * 8 * 128);
  if (tid < kTok * 4) {
    const int rr = tid / 4, ck = tid % 4;
    const uint32_t kr = tile + 8 * kPanelT + rr * 128;
    widen16(lds128(raw + 2 * kRawHalf + rr * 64 + ck * 16),
            kr + (((2 * ck) ^ (rr % 8)) << 4),
            kr + (((2 * ck + 1) ^ (rr % 8)) << 4));
  }
}

template <bool kQ8>
__global__ void __launch_bounds__(kThreads, 1)
    split_tc(const __grid_constant__ CUtensorMap qa_map,
             const __grid_constant__ CUtensorMap qr_map,
             const __grid_constant__ CUtensorMap ckv_map,
             const __grid_constant__ CUtensorMap kr_map, const Params p) {
  using L = Layout<kQ8>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t qbar;
  __shared__ int ids[kMaxRange];         // the range's page ids
  __shared__ float2 psc[kQ8 ? kMaxRange : 1];  // int8: their scales
  const uint32_t base = smem_base(smem_raw);
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * kHeads, b = blockIdx.y, split = blockIdx.z;
  const int ps = p.ps, pps = kTok / ps, ps_log2 = 31 - __clz(ps);

  // this CTA's range: live stages [split, split + 1) * n_lst / n_split
  // of the request
  const int pos = p.pos[b];
  const int n_pages = (p.length + ps - 1) / ps;
  const int n_live = pos < 0 ? 0 : min(n_pages, pos / ps + 1);
  const int n_lst = (n_live + pps - 1) / pps;
  const int p_begin = split * n_lst / p.n_split * pps;
  const int p_end = min(n_live, (split + 1) * n_lst / p.n_split * pps);
  const int nh = min(kHeads, p.H - h0);
  const int64_t row0 = static_cast<int64_t>(b) * p.H + h0;
  if (p_begin >= p_end) {
    for (int g = tid; g < nh; g += kThreads)
      p.part_ml[(row0 + g) * p.n_split + split] = make_float2(kNegInf, 0.0f);
    return;
  }
  const int n_st = (p_end - p_begin + pps - 1) / pps;

  // stage t: pages p_begin + t * pps + i, a slot past the range taking
  // the stage's first page again (masked)
  auto issue = [&](int t) {
    const int s = t % kStages;
    const int k0 = t * pps;  // the stage's first page, within the range
    const uint32_t dst = base + L::ring + s * L::stage;
    mbar_expect(&full[s], L::stage);
#pragma unroll
    for (int i = 0; i < kTok / 8; ++i) {
      if (i >= pps) break;
      const int k = k0 + i;
      const int row = ids[k < p_end - p_begin ? k : k0] * ps;
      if (kQ8) {
        for (int h = 0; h < 2; ++h)
          tma_load_2d(dst + h * kRawHalf + i * ps * 256, &ckv_map, &full[s],
                      256 * h, row);
        tma_load_2d(dst + 2 * kRawHalf + i * ps * 64, &kr_map, &full[s], 0,
                    row);
      } else {
        for (int c = 0; c < 8; ++c)
          tma_load_2d(dst + c * kPanelT + i * ps * 128, &ckv_map, &full[s],
                      64 * c, row);
        tma_load_2d(dst + 8 * kPanelT + i * ps * 128, &kr_map, &full[s], 0,
                    row);
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    mbar_init(&qbar);
    mbar_init_fence();
    mbar_expect(&qbar, kQBytes);
    for (int c = 0; c < 8; ++c)
      tma_load_3d(base + c * kPanelQ, &qa_map, &qbar, 64 * c, h0, b);
    tma_load_3d(base + 8 * kPanelQ, &qr_map, &qbar, 0, h0, b);
  }
  // the range's page ids, while Q lands
  const int* btr = p.bt + static_cast<int64_t>(b) * p.bt_cols;
  for (int k = tid; k < p_end - p_begin; k += kThreads)
    ids[k] = btr[p_begin + k];
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < kStages && t < n_st; ++t) issue(t);
  // int8: the pages' scales, while the first stages land (first read after
  // the block barrier at the top of stage 0)
  if (kQ8)
    for (int k = tid; k < p_end - p_begin; k += kThreads)
      psc[k] = make_float2(p.ckv_scale[ids[k]], p.krope_scale[ids[k]]);

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row = 16 * warp + lane / 4, t4 = lane % 4;  // rows row, row + 8
  float run[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) run[c][v] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: own columns
  // int8: the first stage widened before the loop, each next one while
  // the scores of the stage before it run
  auto widen = [&](int t) {
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    widen_stage(base + L::ring + (t % kStages) * L::stage,
                base + L::wide + (t & 1) * kTileBytes, tid);
    fence_async_smem();
  };
  if (kQ8) widen(0);
  mbar_wait(&qbar, 0);

  for (int t = 0; t < n_st; ++t) {
    const int s = t % kStages;
    // every wgmma of stage t - 1 is done (each warpgroup waited): its ring
    // slot (int8: its widened tile) may be refilled; int8: stage t's
    // widened tile is complete
    if (t > 0 || kQ8) __syncthreads();
    if (tid == 0 && t > 0 && t - 1 + kStages < n_st) issue(t - 1 + kStages);
    uint32_t tile;
    if (kQ8) {
      tile = base + L::wide + (t & 1) * kTileBytes;
    } else {
      mbar_wait(&full[s], (t / kStages) & 1);
      tile = base + L::ring + s * L::stage;
    }

    // scores of the stage's 32 rows (each warpgroup its own copy)
    float sc[16], sr[16];
    wg_fence();
    if (kQ8) {
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk)
        Mma<32>::ss(sc, T::kmajor<kHeads>(base, kk), T::kmajor<kTok>(tile, kk),
                    kk > 0);
#pragma unroll
      for (int kk = kR / 16; kk < kK / 16; ++kk)
        Mma<32>::ss(sr, T::kmajor<kHeads>(base, kk), T::kmajor<kTok>(tile, kk),
                    kk > kR / 16);
    } else {
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk)
        Mma<32>::ss(sc, T::kmajor<kHeads>(base, kk), T::kmajor<kTok>(tile, kk),
                    kk > 0);
    }
    wg_commit();
    if (kQ8 && t + 1 < n_st) widen(t + 1);
    wg_wait();
    fence_regs(sc);
    if (kQ8) fence_regs(sr);

    // entry 4 c + 2 i + e: head row + 8 i, stage row n = 8 c + 2 t4 + e,
    // chain entry j = pg0 * ps + n (live iff j < p_end * ps, j <= pos and
    // j < length); the online softmax of the two rows
    const int j0 = (p_begin + t * pps) * ps;
    const int j_end = min(p_end * ps, min(pos + 1, p.length));
    // int8: the page scales of this thread's eight stage rows (a slot past
    // the range reads the stage's first page's)
    float2 f8[kQ8 ? 8 : 1];
    if (kQ8) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = t * pps + ((8 * c + 2 * t4 + e) >> ps_log2);
          f8[2 * c + e] = psc[k < p_end - p_begin ? k : t * pps];
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * c + 2 * t4 + e, v = 4 * c + 2 * i + e;
          float x = sc[v];
          if (kQ8) {
            const float2 f = f8[kQ8 ? 2 * c + e : 0];
            x = __fadd_rn(__fmul_rn(x, f.x), __fmul_rn(sr[v], f.y));
          }
          x = j0 + n < j_end ? __fmul_rn(x, p.scale) : kNegInf;
          sc[v] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp_e(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = 4 * c + 2 * i + e;
          const float w = exp_e(sc[v] - m[i]);
          l[i] += w;
          sc[v] = kQ8 ? __fmul_rn(w, f8[kQ8 ? 2 * c + e : 0].x) : w;
        }
    uint32_t f[kSplit][2][4];
    split_frag<32>(sc, f);
    // (skipped where no row of the warp has a new max: alpha is then 1)
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int v = 0; v < 32; ++v) run[c][v] *= alpha[(v / 2) % 2];
    }

    // this warpgroup's latent columns, 64 at a time: the stage's product
    // in a fresh accumulator (two alternate, so a chunk's products run
    // while the one before is added), added to the running sum in fp32
    float o[2][32];
    auto chunk = [&](int c) {
      const uint32_t panel = tile + (wg * kChunks + c) * kPanelT;
      wg_fence();
#pragma unroll
      for (int i = kSplit - 1; i >= 0; --i)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          Mma<64>::rs(o[c & 1], f[i][kk], T::mnmajor(panel, kk),
                      i < kSplit - 1 || kk > 0);
      wg_commit();
    };
    chunk(0);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c + 1 < kChunks) {
        chunk(c + 1);
        wg_wait_1();
      } else {
        wg_wait();
      }
      fence_regs(o[c & 1]);
#pragma unroll
      for (int v = 0; v < 32; ++v)
        run[c][v] = __fadd_rn(run[c][v], o[c & 1][v]);
    }
    keep(f);
  }

  // this range's unnormalized sum and (m, l) of each live head row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int g = row + 8 * i;
    if (g >= nh) continue;
    const int64_t prow = (row0 + g) * p.n_split + split;
    float* dst = p.part_acc + prow * kR + 256 * wg + 2 * t4;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        *reinterpret_cast<float2*>(dst + 64 * c + 8 * cc) =
            make_float2(run[c][4 * cc + 2 * i], run[c][4 * cc + 2 * i + 1]);
    if (wg == 0 && t4 == 0) p.part_ml[prow] = make_float2(m[i], li);
  }
}

// One block of kR / 4 threads per (head, request): the ranges' partial
// sums rescaled to their common max, acc / max(l, 1e-30) in bf16.  A
// range with l = 0 (no live page) wrote only its (m, l) and adds nothing.
// Each thread owns four columns; the ranges' loads are issued four at a
// time ahead of their sums (in range order), so they overlap.
__global__ void __launch_bounds__(kR / 4)
    combine_tc(const float* __restrict__ part_acc,
               const float2* __restrict__ part_ml,
               __nv_bfloat16* __restrict__ out, int H, int n_split) {
  const int64_t row = static_cast<int64_t>(blockIdx.y) * H + blockIdx.x;
  const float2* ml = part_ml + row * n_split;
  const float4* acc = reinterpret_cast<const float4*>(part_acc) +
                      row * n_split * (kR / 4) + threadIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[s].x);
  float l = 0.0f;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < n_split; s0 += 4) {
    float w[4];
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + j;
      const float2 f = s < n_split ? ml[s] : make_float2(kNegInf, 0.0f);
      w[j] = f.y != 0.0f ? expf(f.x - mx) : 0.0f;
      l = fmaf(w[j], f.y, l);
      v[j] = w[j] != 0.0f ? acc[s * (kR / 4)]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.x = fmaf(w[j], v[j].x, a.x);
      a.y = fmaf(w[j], v[j].y, a.y);
      a.z = fmaf(w[j], v[j].z, a.z);
      a.w = fmaf(w[j], v[j].w, a.w);
    }
  }
  const float lg = fmaxf(l, 1e-30f);
  __nv_bfloat162* o =
      reinterpret_cast<__nv_bfloat162*>(out + row * kR) + 2 * threadIdx.x;
  o[0] = __floats2bfloat162_rn(a.x / lg, a.y / lg);
  o[1] = __floats2bfloat162_rn(a.z / lg, a.w / lg);
}

// The tensor map of a row-major operand: `dims` elements of `elem` bytes
// (innermost first, rank 2 or 3), read in boxes of `box` elements.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                    const void* ptr, int rank, const uint64_t* dims,
                    const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[3], st[2];
  cuuint32_t bx[3], unit[3] = {1, 1, 1};
  uint64_t stride = static_cast<uint64_t>(elem);
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    stride *= dims[i];
    if (i + 1 < rank) st[i] = stride;
  }
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), d, st, bx,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline bool misaligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

// Split kernel and combine; cudaErrorInvalidValue for a shape or an
// alignment the route does not take (ops.mla_route says which) or an
// n_split that leaves a range more than kMaxRange pages.
template <bool kQ8>
int launch(const void* q_abs, const void* q_rope, const void* pool_ckv,
           const void* pool_krope, const void* ckv_scale,
           const void* krope_scale, const void* bt, const void* pos,
           void* part_acc, void* part_ml, void* out, int B, int H, int r,
           int dr, int P, int ps, int bt_cols, int length, int n_split,
           float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || r != kR || dr != kDR || P < 1 ||
      (ps != 8 && ps != 16 && ps != 32) || length < 1 || n_split < 1 ||
      n_split > 65535 || misaligned(q_abs) || misaligned(q_rope) ||
      misaligned(pool_ckv) || misaligned(pool_krope))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pps = kTok / ps;
  const long long n_stages = ((length + ps - 1) / ps + pps - 1) / pps;
  if ((n_stages + n_split - 1) / n_split * pps > kMaxRange)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType kv_type = kQ8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int kv_elem = kQ8 ? 1 : 2;
  const CUtensorMapSwizzle kv_swizzle =
      kQ8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap qa_map, qr_map, ckv_map, kr_map;
  const uint64_t qa_dims[3] = {kR, static_cast<uint64_t>(H),
                               static_cast<uint64_t>(B)};
  const uint64_t qr_dims[3] = {kDR, static_cast<uint64_t>(H),
                               static_cast<uint64_t>(B)};
  const uint32_t q_box[3] = {64, kHeads, 1};
  const uint64_t rows = static_cast<uint64_t>(P) * ps;
  const uint64_t ckv_dims[2] = {kR, rows}, kr_dims[2] = {kDR, rows};
  const uint32_t ckv_box[2] = {kQ8 ? 256u : 64u, static_cast<uint32_t>(ps)};
  const uint32_t kr_box[2] = {64, static_cast<uint32_t>(ps)};
  int err = make_map(&qa_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q_abs, 3,
                     qa_dims, q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = make_map(&qr_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q_rope, 3,
                   qr_dims, q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = make_map(&ckv_map, kv_type, kv_elem, pool_ckv, 2, ckv_dims,
                   ckv_box, kv_swizzle);
  if (!err)
    err = make_map(&kr_map, kv_type, kv_elem, pool_krope, 2, kr_dims, kr_box,
                   kv_swizzle);
  if (err) return err;
  // on every launch: the attribute belongs to the current device's
  // context, and a host-side call costs less than a microsecond
  auto kernel = split_tc<kQ8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<kQ8>::smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  p.bt = static_cast<const int*>(bt);
  p.pos = static_cast<const int*>(pos);
  p.ckv_scale = static_cast<const float*>(ckv_scale);
  p.krope_scale = static_cast<const float*>(krope_scale);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float2*>(part_ml);
  p.H = H;
  p.ps = ps;
  p.bt_cols = bt_cols;
  p.length = length;
  p.n_split = n_split;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + kHeads - 1) / kHeads, B, n_split);
  kernel<<<grid, kThreads, Layout<kQ8>::smem, st>>>(qa_map, qr_map, ckv_map,
                                                    kr_map, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_tc<<<dim3(H, B), kR / 4, 0, st>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float2*>(part_ml), static_cast<__nv_bfloat16*>(out),
      H, n_split);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the split kernel: registers and local (spill
// and stack) bytes a thread, dynamic shared bytes, resident CTAs an SM,
// threads a CTA.
template <bool kQ8>
int info(int* out) {
  auto kernel = split_tc<kQ8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<kQ8>::smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, Layout<kQ8>::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[5] = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    Layout<kQ8>::smem, blocks, kThreads};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

}  // namespace tc
}  // namespace paged_mla
