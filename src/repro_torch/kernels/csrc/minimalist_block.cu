// The MINIMALIST core over a whole sequence, fused: at every step t both
// 2 b-code projections, the 6 b SAR-ADC gate, the capacitor-swap state
// update and the comparator, for x (B, T, K) fp32, codes (K, N) int8 (2 b:
// 0..3), biases (N,) fp32 and h0 (B, N) fp32:
//
//   pre_h = (x_t @ (codes_h - 1.5)) * scale + bh
//   pre_z = (x_t @ (codes_z - 1.5)) * scale + bz
//   z     = floor(clip(pre_z / 6 + 1/2, 0, 1) * 63) / 63
//   h_t   = z * pre_h + (1 - z) * h_{t-1},   y_t = (h_t > 0)
//
// Outputs y and h, both (B, T, N) fp32.
//
// Replaces the TPU kernel minimalist_block_pallas
// (src/repro/kernels/minimalist_block/minimalist_block.py:125, _kernel :35),
// which walks time chunks of a (B, N/nblk, T/tblk) grid in order, runs both
// projections of a chunk on the MXU and carries h in VMEM.
//
// Bound.  The projections do not depend on h: they are a product of B*T
// rows, 4*B*T*K*N operations that the tensor cores do in far less time
// than the card takes to read x (B*T*K*4 bytes) and write y and h
// (2*B*T*N*4 bytes).  So at large B*T the kernel is bound by bytes (at
// (256, 784, 64 -> 64) 154 MB, 0.046 ms).  Only the state update is a
// chain: two dependent fp32 operations a frame, about 8 cycles, so at
// small B the least time is T * 8 cycles (0.45 us at T 98, 3.6 us at T
// 784), whatever the width.
//
// Design.  One CTA owns one batch row b and a slab of SLAB columns (8, 16,
// 32 or 64; ops.block_plan picks the widest slab that still gives every
// SM a CTA, else the narrowest) and walks time in chunks of 64 frames.
// It has two roles, handed chunks through two shared buffers with named
// barriers (full: the warpgroup arrives, the chain waits; empty: the
// other way), so the warpgroup projects chunk c + 1 while the chain walks
// chunk c:
//
// - A projection warpgroup (threads 0..127).  For each chunk (and each
//   64-column panel of K) every thread loads, one unit ahead, exactly the
//   x entries of its wgmma A fragments (rows r and r + 8 of its warp's 16
//   frames, 8- or 4-byte loads, so rows of x need not be aligned: K is 1
//   in every first layer).  It splits each fp32 x into three bf16 parts
//   (hi, mid, lo: their sum is x exactly) in registers and runs wgmma
//   m64nSLABk16 with A from registers against the slab's levels (c - 1.5,
//   exact in bf16, widened from the int8 codes into swizzled K-major
//   shared tiles once a CTA, or once a chunk when K is too large for them
//   to stay), once for h and once for z, summing in fp32.  Every part x
//   level product is exact in fp32, so on binary x (mid and lo zero, every
//   partial sum a multiple of 1/2) the sums equal the plain version's bit
//   for bit in any order, and on analog x they are within fp32 rounding of
//   it.  A chunk whose x has no mid or lo bits (one barrier reduction over
//   the warpgroup) runs only the hi part.  The epilogue turns each pair of
//   sums into the gate in the plain version's op order, each operation
//   rounded alone (__fmul_rn, __fadd_rn: nvcc cannot contract them; the
//   division by 6 as an fp64 product, see div6), +0 added first (the
//   tensor cores may leave -0 where the plain sum is +0), z and 1 - z read
//   from a table of code / 63, and writes z * pre_h and 1 - z of every
//   (frame, column) into a buffer.
// - Chain threads, one a column.  Each keeps its h in a register and walks
//   a chunk's frames from a buffer: h = z*pre_h + (1-z)*h, written back in
//   place of z*pre_h, then stores its warp's columns of h and y (16-byte
//   stores where N allows), coalesced along n.  That is the whole time
//   loop: a shared load, two dependent fp32 operations and a shared store
//   a frame.  It stays sequential in t: an affine chunked scan would
//   reorder the rounding and lose the plain version's bits.
//
// What the chain costs on the card: it runs about 15 cycles a frame alone
// and 30-50 beside the warpgroup's loads, products and gates on the same
// SM, so narrow slabs (less projection work an SM) serve small batches
// best.  Ragged edges are zero-filled (K to a whole panel, a slab's
// columns past N, frames past T) or not stored; nothing is padded in
// device memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace minimalist_block {

using namespace ::sm90;

constexpr int kChunk = 64;       // frames a chunk: wgmma's 64 rows
constexpr int kPanel = 64;       // K columns a panel: one 128-byte bf16 row
constexpr int kSteps = kPanel / 16;         // wgmma k-steps a panel
constexpr int kProj = 128;       // threads of the projection warpgroup
constexpr int kLevelBudget = 96 * 1024;     // levels that stay resident

// Named barriers: 0 is __syncthreads, 1 the projection warpgroup's own,
// 2 + s "buffer s full", 4 + s "buffer s empty".
constexpr int kBarProj = 1, kBarFull = 2, kBarEmpty = 4;

template <int SLAB>
struct Layout {
  static constexpr int kChainWarps = (SLAB + 31) / 32;
  static constexpr int kThreads = kProj + 32 * kChainWarps;
  static constexpr int kMinBlocks = SLAB <= 16 ? 3 : 2;
  static constexpr int kLd = SLAB + 4;       // float2 a buffer row
  static constexpr int kTile = SLAB * 128;   // one matrix's levels, a panel
  static constexpr int kBufBytes = kChunk * kLd * 8;
  // byte offsets from the 1024-aligned base, for `slots` level panels
  static constexpr __host__ __device__ int buf_off(int slots) {
    return slots * 2 * kTile;
  }
  static constexpr __host__ __device__ int bias_off(int slots) {
    return buf_off(slots) + 2 * kBufBytes;
  }
  static constexpr __host__ __device__ int table_off(int slots) {
    return bias_off(slots) + 2 * SLAB * 4;
  }
  static constexpr __host__ __device__ int smem(int slots) {
    return table_off(slots) + 64 * 8 + 1024;   // + alignment of the base
  }
};

struct Params {
  const float* x;
  const int8_t* ch;
  const int8_t* cz;
  const float* bh;
  const float* bz;
  const float* h0;
  float* y;
  float* h;
  float scale;
  int T, K, N;
  int panels;     // 64-column panels of K (at least one)
  int resident;   // 1: every panel's levels stay in shared memory
  int vec;        // 1: pairs of x load as 8-byte vectors
  int vec_out;    // 1: h and y store as 16-byte vectors
};

// d (64 x N) += A.B: A (64 x 16 bf16) in registers, B K-major in shared
// memory (no transpose).
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void rs(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// A barrier over n threads that also tells each whether any had `pred`.
__device__ __forceinline__ int bar_any(int id, int n, int pred) {
  int any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\nselp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"(pred), "r"(id), "r"(n)
      : "memory");
  return any;
}

// Part q of the three bf16 parts of (x0, x1) as bf16x2 (x0 low): part 0
// = bf16(x), part i = bf16(x - parts 0..i-1); the three sum to x exactly.
__device__ __forceinline__ uint32_t part(float x0, float x1, int q) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    if (i == q) out = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __bfloat162float(h.x);
    x1 -= __bfloat162float(h.y);
  }
  return out;
}

// The levels of panel p of the slab from n0 (h rows, then z rows; each a
// swizzled K-major tile of SLAB rows x 64 bf16) into shared memory at
// dst (generic), by `nthr` threads from `tid`; zero past K and past N.
template <int SLAB>
__device__ __forceinline__ void widen(const Params& P, int n0, int p,
                                      uint8_t* dst, int tid, int nthr) {
#pragma unroll 4
  for (int i = tid; i < 2 * SLAB * kPanel; i += nthr) {
    const int n = i % SLAB, kc = (i / SLAB) % kPanel;
    const int hz = i / (SLAB * kPanel);
    const int k = p * kPanel + kc, col = n0 + n;
    float v = 0.0f;
    if (k < P.K && col < P.N)
      v = static_cast<float>(
              (hz ? P.cz : P.ch)[static_cast<int64_t>(k) * P.N + col]) -
          1.5f;
    *reinterpret_cast<__nv_bfloat16*>(
        dst + hz * SLAB * 128 + n * 128 + (((kc >> 3) ^ (n & 7)) << 4) +
        (kc & 7) * 2) = __float2bfloat16_rn(v);
  }
}

// The x entries of this thread's A fragments for unit u (chunk u /
// panels, panel u % panels): xr[4 kk + i] holds row r + 8 (i & 1),
// columns 16 kk + 8 (i >> 1) + 2 t4 and one more; zero past T and K.
// One row pointer a thread, the column offsets immediates, each load
// predicated.
__device__ __forceinline__ void load_x(const Params& P, int b, int u,
                                       int r, int t4, float2 (&xr)[16]) {
  const int c = u / P.panels, p = u - c * P.panels;
  const int t = c * kChunk + r;
  const float* row = P.x + (static_cast<int64_t>(b) * P.T + t) * P.K +
                     p * kPanel + 2 * t4;
  const int left = P.K - p * kPanel - 2 * t4;   // columns from row on
  const int64_t down = 8 * static_cast<int64_t>(P.K);
#pragma unroll
  for (int j = 0; j < 8; ++j) {                // columns 8 j, 8 j + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {              // rows t, t + 8
      const bool ok = t + 8 * h < P.T;
      const float* src = row + h * down + 8 * j;
      float2 v = make_float2(0.0f, 0.0f);
      if (P.vec) {
        if (ok && 8 * j < left) v = __ldg(reinterpret_cast<const float2*>(src));
      } else {
        if (ok && 8 * j < left) v.x = __ldg(src);
        if (ok && 8 * j + 1 < left) v.y = __ldg(src + 1);
      }
      xr[4 * (j / 2) + 2 * (j % 2) + h] = v;
    }
  }
}

// acc_h, acc_z (64 x SLAB) (+)= bf16 part q of x times the panel's h and
// z levels at lv: the four k-steps of a panel, A from registers.
template <int SLAB>
__device__ __forceinline__ void mma_part(float (&acc_h)[SLAB / 2],
                                         float (&acc_z)[SLAB / 2],
                                         const float2 (&xr)[16], int q,
                                         uint32_t lv, int first,
                                         uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = part(xr[4 * kk + i].x, xr[4 * kk + i].y, q);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int acc = !(first && kk == 0);
    Mma<SLAB>::rs(acc_h, a[kk], desc(lv + kk * 32, 16, 1024, 1), acc);
    Mma<SLAB>::rs(acc_z, a[kk], desc(lv + SLAB * 128 + kk * 32, 16, 1024, 1),
                  acc);
  }
  wg_commit();
}

// Keep the A fragments of in-flight wgmmas in their registers until the
// wait (wgmma reads them asynchronously).
__device__ __forceinline__ void keep(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]));
}

// x / 6 rounded once to fp32, with no divide and no call: the fp64
// product is within 2^-53 of x / 6, and x / 6 is either an fp32 or at
// least a sixth of an ulp from an fp32 rounding midpoint (x / 3 has
// digits 0101... past fp32's), so it rounds as __fdiv_rn(x, 6.0f) does
// wherever the quotient is normal.  Where it is not, both are far below
// half an ulp of the 1/2 the gate adds next, so the gate agrees.
__device__ __forceinline__ float div6(float x) {
  return __double2float_rn(static_cast<double>(x) * (1.0 / 6.0));
}

// (z * pre_h, 1 - z) of one (frame, column) from its two sums.
__device__ __forceinline__ float2 gate(float acc_h, float acc_z, float bh,
                                       float bz, float scale,
                                       const float2* table) {
  const float pre_h = __fadd_rn(__fmul_rn(__fadd_rn(acc_h, 0.0f), scale), bh);
  const float pre_z = __fadd_rn(__fmul_rn(__fadd_rn(acc_z, 0.0f), scale), bz);
  // SAR-ADC transfer: mid-rise floor on the 63-unit capacitor grid
  const float v =
      fminf(fmaxf(__fadd_rn(div6(pre_z), 0.5f), 0.0f), 1.0f);
  const float2 z = table[static_cast<int>(floorf(__fmul_rn(v, 63.0f)))];
  return make_float2(__fmul_rn(z.x, pre_h), z.y);
}

// h and y of a walked chunk (h in the .x of its buffer) to device memory
// by chain warp w, which walked columns 32 w .. 32 w + W - 1 of the slab:
// rows of W columns, coalesced along n (16-byte stores where N allows).
template <int SLAB>
__device__ __forceinline__ void store_chunk(const Params& P, int b, int n0,
                                            int c, const float2* buf, int w,
                                            int lane) {
  using L = Layout<SLAB>;
  constexpr int W = SLAB < 32 ? SLAB : 32;
  const int frames = min(kChunk, P.T - c * kChunk);
  const int64_t row0 = static_cast<int64_t>(b) * P.T + c * kChunk;
  if (P.vec_out) {
    // four columns a lane: two 16-byte shared loads, two 16-byte stores
    constexpr int kQuads = W / 4;
    const int j = 32 * w + 4 * (lane % kQuads), col = n0 + j;
    if (col >= P.N) return;
#pragma unroll 4
    for (int i = lane / kQuads; i < frames; i += 32 / kQuads) {
      const float4 e0 = *reinterpret_cast<const float4*>(buf + i * L::kLd + j);
      const float4 e1 =
          *reinterpret_cast<const float4*>(buf + i * L::kLd + j + 2);
      const float4 h = make_float4(e0.x, e0.z, e1.x, e1.z);
      const int64_t o = (row0 + i) * P.N + col;
      *reinterpret_cast<float4*>(P.h + o) = h;
      *reinterpret_cast<float4*>(P.y + o) =
          make_float4(h.x > 0.0f ? 1.0f : 0.0f, h.y > 0.0f ? 1.0f : 0.0f,
                      h.z > 0.0f ? 1.0f : 0.0f, h.w > 0.0f ? 1.0f : 0.0f);
    }
    return;
  }
  const int j = 32 * w + lane % W, col = n0 + j;
  if (col >= P.N) return;
#pragma unroll 4
  for (int i = lane / W; i < frames; i += 32 / W) {
    const float h = buf[i * L::kLd + j].x;
    const int64_t o = (row0 + i) * P.N + col;
    P.h[o] = h;
    P.y[o] = h > 0.0f ? 1.0f : 0.0f;
  }
}

template <int SLAB>
__device__ __forceinline__ void project(const Params& P, int b, int n0,
                                        uint32_t base, uint8_t* gen,
                                        float2* bufs, const float* sb,
                                        const float2* table, int tid,
                                        float2 (&xr)[16]) {
  using L = Layout<SLAB>;
  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, t4 = lane % 4;
  const int chunks = (P.T + kChunk - 1) / kChunk;
  const int units = chunks * P.panels;

  float acc_h[SLAB / 2], acc_z[SLAB / 2];
  uint32_t a[kSteps][4];
  int u = 0;
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    float2* buf = bufs + s * kChunk * L::kLd;
    for (int p = 0; p < P.panels; ++p, ++u) {
      const int slot = P.resident ? p : 0;
      if (!P.resident) {
        // the previous panel's wgmmas are done in every warp
        bar_sync(kBarProj, kProj);
        widen<SLAB>(P, n0, p, gen + slot * 2 * L::kTile, tid, kProj);
        fence_async_smem();
      }
      // x has mid or lo bits where bf16 cannot hold it: where any of its
      // low 16 bits is set
      uint32_t mixed = 0;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        mixed |= __float_as_uint(xr[e].x) | __float_as_uint(xr[e].y);
      mixed &= 0xFFFFu;
      const bool all3 = bar_any(kBarProj, kProj, mixed != 0);
      const uint32_t lv = base + slot * 2 * L::kTile;
      mma_part<SLAB>(acc_h, acc_z, xr, 0, lv, p == 0, a);
      if (all3) {
#pragma unroll
        for (int q = 1; q < 3; ++q) {
          wg_wait();
          keep(a);
          mma_part<SLAB>(acc_h, acc_z, xr, q, lv, 0, a);
        }
      }
      // the next unit's x is on its way while the wgmmas run
      if (u + 1 < units) load_x(P, b, u + 1, r, t4, xr);
      wg_wait();
      keep(a);
      fence_regs(acc_h);
      fence_regs(acc_z);
    }
    // buffer s is free once the chain has walked chunk c - 2 out of it
    // and stored it
    if (c >= 2) bar_sync(kBarEmpty + s, L::kThreads);
#pragma unroll
    for (int j = 0; j < SLAB / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 bh = *reinterpret_cast<const float2*>(sb + col);
      const float2 bz = *reinterpret_cast<const float2*>(sb + SLAB + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i;
        const float2 g0 = gate(acc_h[e], acc_z[e], bh.x, bz.x, P.scale, table);
        const float2 g1 =
            gate(acc_h[e + 1], acc_z[e + 1], bh.y, bz.y, P.scale, table);
        *reinterpret_cast<float4*>(buf + (r + 8 * i) * L::kLd + col) =
            make_float4(g0.x, g0.y, g1.x, g1.y);
      }
    }
    bar_arrive(kBarFull + s, L::kThreads);
  }
}

template <int SLAB>
__device__ __forceinline__ void chain(const Params& P, int b, int n0,
                                      float2* bufs, int tid) {
  using L = Layout<SLAB>;
  const int j = tid - kProj;
  const bool on = j < SLAB && n0 + j < P.N;
  float h = on ? P.h0[static_cast<int64_t>(b) * P.N + n0 + j] : 0.0f;
  const int chunks = (P.T + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    float2* buf = bufs + s * kChunk * L::kLd;
    bar_sync(kBarFull + s, L::kThreads);
    if (on) {
      float2* e = buf + j;
      const int frames = min(kChunk, P.T - c * kChunk);
#pragma unroll 8
      for (int i = 0; i < frames; ++i) {
        const float2 g = e[i * L::kLd];
        // capacitor-swap update; h replaces z * pre_h in the buffer
        h = __fadd_rn(g.x, __fmul_rn(g.y, h));
        e[i * L::kLd].x = h;
      }
    }
    __syncwarp();
    store_chunk<SLAB>(P, b, n0, c, buf, j / 32, j % 32);
    if (c + 2 < chunks) bar_arrive(kBarEmpty + s, L::kThreads);
  }
}

template <int SLAB>
__global__ void __launch_bounds__(Layout<SLAB>::kThreads,
                                  Layout<SLAB>::kMinBlocks)
    block_kernel(const Params P) {
  using L = Layout<SLAB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));
  const int slots = P.resident ? P.panels : 1;
  float2* bufs = reinterpret_cast<float2*>(gen + L::buf_off(slots));
  float* sb = reinterpret_cast<float*>(gen + L::bias_off(slots));
  float2* table = reinterpret_cast<float2*>(gen + L::table_off(slots));
  const int tid = threadIdx.x;
  const int b = blockIdx.y, n0 = blockIdx.x * SLAB;

  // the first chunk's x is on its way while the levels are widened
  float2 xr[16];
  if (tid < kProj)
    load_x(P, b, 0, 16 * (tid / 32) + tid % 32 / 4, tid % 4, xr);
  if (P.resident)
    for (int p = 0; p < P.panels; ++p)
      widen<SLAB>(P, n0, p, gen + p * 2 * L::kTile, tid, L::kThreads);
  for (int i = tid; i < SLAB; i += L::kThreads) {
    const int col = n0 + i;
    sb[i] = col < P.N ? P.bh[col] : 0.0f;
    sb[SLAB + i] = col < P.N ? P.bz[col] : 0.0f;
  }
  if (tid < 64) {
    const float z = __fdiv_rn(static_cast<float>(tid), 63.0f);
    table[tid] = make_float2(z, __fsub_rn(1.0f, z));
  }
  fence_async_smem();
  __syncthreads();

  if (tid < kProj)
    project<SLAB>(P, b, n0, base, gen, bufs, sb, table, tid, xr);
  else
    chain<SLAB>(P, b, n0, bufs, tid);
}

template <int SLAB>
int launch(const Params& P, int B, cudaStream_t stream) {
  using L = Layout<SLAB>;
  const int smem = L::smem(P.resident ? P.panels : 1);
  // on every launch: the attribute belongs to the current device's
  // context, and a host-side call costs less than a microsecond
  const cudaError_t e = cudaFuncSetAttribute(
      block_kernel<SLAB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P.N + SLAB - 1) / SLAB, B);
  block_kernel<SLAB><<<grid, L::kThreads, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace minimalist_block

// slab: the columns a CTA owns (8, 16, 32 or 64; ops.block_plan chooses);
// cudaErrorInvalidValue for any other or an empty shape.
extern "C" int minimalist_block_f32(const void* x, const void* codes_h,
                                    const void* codes_z, float scale,
                                    const void* bh, const void* bz,
                                    const void* h0, void* y, void* h_out,
                                    int B, int steps, int K, int N, int slab,
                                    void* stream) {
  using namespace minimalist_block;
  if (B < 1 || steps < 1 || K < 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  Params P;
  P.x = static_cast<const float*>(x);
  P.ch = static_cast<const int8_t*>(codes_h);
  P.cz = static_cast<const int8_t*>(codes_z);
  P.bh = static_cast<const float*>(bh);
  P.bz = static_cast<const float*>(bz);
  P.h0 = static_cast<const float*>(h0);
  P.y = static_cast<float*>(y);
  P.h = static_cast<float*>(h_out);
  P.scale = scale;
  P.T = steps;
  P.K = K;
  P.N = N;
  P.panels = K < 1 ? 1 : (K + kPanel - 1) / kPanel;
  P.resident = P.panels * 2 * slab * 128 <= kLevelBudget;
  P.vec = K % 2 == 0 && aligned(x, 8);
  P.vec_out = N % 4 == 0 && aligned(y, 16) && aligned(h_out, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slab) {
    case 8:
      return launch<8>(P, B, s);
    case 16:
      return launch<16>(P, B, s);
    case 32:
      return launch<32>(P, B, s);
    case 64:
      return launch<64>(P, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
