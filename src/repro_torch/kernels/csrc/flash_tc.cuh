// Flash attention on Hopper's tensor cores: the "tc" route of flash_fwd.cu
// and flash_bwd.cu, for bf16 inputs at head dims 16, 32, 64, 128, 160 and
// 256 (and any head dim from 129 to 256 at the next of the last two).
//
// Each warpgroup (128 threads) owns a 64-row tile of its output and keeps
// its accumulators in registers; a block is one warpgroup, or two (the
// forward above head dim 128: two query tiles; the dK/dV kernel from 128:
// dK and dV of one key tile).  The operand tiles
// stream through shared memory in a ring of two stages: thread 0 starts
// TMA loads (4-D tensor maps over (D, S, heads, batch) built from the
// operands' strides, so transposed views load with no copy, and rows past
// S arrive as zeros), each stage signals an mbarrier when its bytes have
// landed, and the stage is refilled as soon as the warpgroup's wgmma
// reads of it are done.  Products are wgmma m64nNk16 with fp32
// accumulators.
//
// Numerics are the CUDA-core route's (flash_attention.cuh): a bf16 x bf16
// product is exact in fp32, so q.k^T and do.v^T on wgmma are fp32 products
// of the inputs summed in fp32.  P, dS and their transposes are fp32 and
// meet a bf16 operand: rounding them once to bf16 (as FA2/FA3 do) moves
// about an eighth of the outputs past one bf16 ulp of the fp32 result.
// So each is split in registers into bf16 parts (hi, mid and lo, see
// kSplit) and multiplied once a part; each tile's product is summed in a
// fresh accumulator and added to the running sum in fp32 registers.  The
// outputs stay within one bf16 ulp + 2e-6 of the fp32 plain version.  The
// split needs no shared memory: the fp32 accumulator fragment of
// m64nNk16 holds, two columns at a time, exactly the entries of the bf16
// A-operand fragment of the next product.
//
// Shared-memory tiles: a tile of R rows x D bf16 is stored as NP = D / PW
// panels (rounded up) of R rows x PW columns, PW = min(D, 64) (one TMA
// box each), with the TMA swizzle whose span is one panel row (128 B at
// D >= 64, 64 B at D 32, 32 B at D 16) and the matching wgmma layout
// type.  A panel is read K-major (q.k^T: D along K) or, with the
// transpose bit, MN-major (p.V: keys along K, D along N).  Every panel
// starts on a 1024-byte boundary, so the swizzle pattern starts at its
// first row.
//
// Head dims past 128: D 160 is three panels (192 columns) and D 256 four.
// The tensor map's inner extent is the true head dim, so TMA fills the
// columns past it with zeros (160-191 at D 160; a head dim of 129-255 run
// at 160 or 256 likewise): q.k^T stops at the compiled D (the zeros add
// nothing), p.V and the gradient products compute the last panel whole
// (at D 160 a fifth more than the true columns) and only the true columns
// are stored.  The products' fp32 sums stay in registers: o, dq, dk or dv
// (D / 2 a thread) beside one product of CP panels: up to D 128 the whole
// product (CP = NP), above it one panel at a time (CP = 1), so the sum
// and the product fit 255 registers at D 256.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace flash {
namespace tc {

using namespace ::sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;

// -- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}

template <int N>
struct Mma;

template <>
struct Mma<16> {
  // d (64 x 16) += A.B: A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }

  // d (64 x 16) += A.B: A (64 x 16 bf16) in registers, B MN-major in
  // shared memory (the transpose bit set)
  static __device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct Mma<32> {
  // d (64 x 32) += A.B: A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }

  // d (64 x 32) += A.B: A (64 x 16 bf16) in registers, B MN-major in
  // shared memory (the transpose bit set)
  static __device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
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
  // d (64 x 64) += A.B: A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }

  // d (64 x 64) += A.B: A (64 x 16 bf16) in registers, B MN-major in
  // shared memory (the transpose bit set)
  static __device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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


// -- tiles ---------------------------------------------------------------

template <int D>
struct Tile {
  static constexpr int PW = D < 64 ? D : 64;      // panel width, elements
  static constexpr int ROWB = PW * 2;             // bytes of a panel row
  static constexpr int NP = (D + PW - 1) / PW;    // panels
  static constexpr int DP = NP * PW;              // columns incl. padding
  static constexpr int CP = DP <= 128 ? NP : 1;   // panels a product holds
  // Either whole panels, or a last one that TMA zero-fills past D, whose
  // columns q.k^T's depth steps of 16 leave out.
  static_assert(D % PW == 0 || (D > 128 && D % 16 == 0),
                "a head dim must fill its panels, or pad the last one");
  static constexpr uint32_t LAYOUT = D >= 64 ? 1 : (D == 32 ? 2 : 3);
  static constexpr CUtensorMapSwizzle SWIZZLE =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B);
  template <int R>
  static constexpr __host__ __device__ int bytes() {
    return R * DP * 2;
  }

  // K-major operand of a tile of R rows: columns 16 kk .. 16 kk + 15.
  template <int R>
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
    const int col = kk * 16;
    return desc(tile + (col / PW) * R * ROWB + (col % PW) * 2, 16, 8 * ROWB,
                LAYOUT);
  }

  // MN-major operand of one panel: rows 16 kk .. 16 kk + 15 along K,
  // the panel's PW columns along N.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t panel, int kk) {
    return desc(panel + kk * 16 * ROWB, 16, 8 * ROWB, LAYOUT);
  }

  // R rows from `row` on of one (batch, head) into the tile at `dst`,
  // one TMA box a panel, completing on `bar`.
  template <int R>
  static __device__ __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int head, int batch) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(dst + p * R * ROWB, map, bar, p * PW, row, head, batch);
  }
};

// acc (64 x CP PW) (+)= A (64 x 16, registers) . rows 16 kk .. 16 kk + 15
// of panels p0 .. p0 + CP - 1 of a tile of R rows x D read MN-major: one
// wgmma of width PW per panel, the panel's columns landing in its slice
// of the accumulator.
template <int D, int R, int CP>
__device__ __forceinline__ void mma_rows(float* acc, const uint32_t (&a)[4],
                                         uint32_t tile, int p0, int kk,
                                         int accumulate) {
  using T = Tile<D>;
#pragma unroll
  for (int p = 0; p < CP; ++p)
    Mma<T::PW>::rs(acc + p * T::PW / 2, a,
                   T::mnmajor(tile + (p0 + p) * R * T::ROWB, kk),
                   accumulate);
}

// acc (64 x N) = A . B^T over D: A 64 rows of a tile of RA rows (`a` at
// its first row) and B a tile of N rows, both K-major.
template <int D, int N, int RA = 64>
__device__ __forceinline__ void mma_dot(float (&acc)[N / 2], uint32_t a,
                                        uint32_t b) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<N>::ss(acc, T::template kmajor<RA>(a, kk),
               T::template kmajor<N>(b, kk), kk > 0);
}

// An fp32 operand x is split into kSplit bf16 parts, x_0 = bf16(x) and
// x_i = bf16(x - x_0 - ... - x_{i-1}): with three, x minus their sum is
// below 2^-24 |x|, an fp32 rounding.  (Two leave up to 2^-16 |x|, which
// moves a few outputs in a million past one bf16 ulp + 2e-6 of the fp32
// plain version where a sum cancels.)
constexpr int kSplit = 3;

// Two entries x0, x1 split into kSplit bf16x2 registers (x0 in the low
// half).
__device__ __forceinline__ void split2(float x0, float x1,
                                       uint32_t (&parts)[kSplit]) {
#pragma unroll
  for (int i = 0; i < kSplit; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    parts[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __bfloat162float(h.x);
    x1 -= __bfloat162float(h.y);
  }
}

// The fp32 accumulator (64 x N) as the bf16 A fragments of the N / 16
// k-steps of the next product, split into kSplit parts.
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N / 2],
                                           uint32_t (&f)[kSplit][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t parts[kSplit];
      split2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], parts);
#pragma unroll
      for (int i = 0; i < kSplit; ++i) f[i][kk][r] = parts[i];
    }
}

// Keep the A fragments of an in-flight wgmma in their registers until
// its wait.
template <int K>
__device__ __forceinline__ void keep(uint32_t (&f)[kSplit][K][4]) {
#pragma unroll
  for (int i = 0; i < kSplit; ++i)
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[i][kk][r]));
}

// acc (64 x CP PW) = X . panels p0 .. p0 + CP - 1 of the tile, X (64 x R)
// given as its split fragments and the tile (R rows x D) read MN-major,
// into a fresh accumulator: the caller adds it to its running fp32 sum on
// the CUDA cores (round to nearest), so the tensor cores only ever sum
// one tile.  Summed over many tiles in the tensor cores, the running dK /
// dV part from the plain version's fp32 sums by more than one bf16 ulp +
// 2e-6 in a few entries in a million.  The smallest parts go first.
template <int D, int R, int CP = Tile<D>::NP>
__device__ __forceinline__ void mma_split(float* acc,
                                          const uint32_t (&f)[kSplit][R / 16]
                                                                 [4],
                                          uint32_t tile, int p0 = 0) {
#pragma unroll
  for (int i = kSplit - 1; i >= 0; --i)
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      mma_rows<D, R, CP>(acc, f[i][kk], tile, p0, kk,
                         i < kSplit - 1 || kk > 0);
}

// sum (64 x D fp32, DP / 2 a thread) = sum * alpha[row half] + X . tile,
// one product of CP panels at a time into a fresh accumulator
// (mma_split), each added on the CUDA cores; alpha is the forward's
// online-softmax rescale, and {1, 1} elsewhere (fmaf(x, 1, y) rounds
// x + y).  X's fragments are kept until the last product has been read.
template <int D, int R>
__device__ __forceinline__ void add_products(
    float (&sum)[Tile<D>::DP / 2], uint32_t (&f)[kSplit][R / 16][4],
    uint32_t tile, const float (&alpha)[2]) {
  using T = Tile<D>;
  constexpr int N = T::CP * T::PW / 2;  // accumulator entries a product
#pragma unroll
  for (int p0 = 0; p0 < T::NP; p0 += T::CP) {
    float part[N];
    wg_fence();
    mma_split<D, R, T::CP>(part, f, tile, p0);
    wg_commit();
    wg_wait();
    fence_regs(part);
    keep(f);
#pragma unroll
    for (int e = 0; e < N; ++e)
      sum[p0 * T::PW / 2 + e] =
          fmaf(sum[p0 * T::PW / 2 + e], alpha[(e >> 1) & 1], part[e]);
  }
}

// e^z as 2^(z log2 e): one multiply and the MUFU, where expf spends about
// eight instructions with its own range reduction.  The product's
// rounding adds |z| 2^-24 relative to p, far inside the outputs' bounds;
// e^0 is still exactly 1 and e^-1e30 exactly 0.
__device__ __forceinline__ float exp_e(float z) {
  return exp2f(__fmul_rn(z, 1.4426950408889634f));
}

// Max and sum over the four threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Whether every (row, key) of the rows [q0, q0 + BQ) x keys [k0, k0 + BK)
// tile is attendable, so the additive mask is 0 throughout and can be
// skipped (adding 0 changes no bit).
__device__ __forceinline__ bool tile_open(int q0, int BQ, int k0, int BK,
                                          int S, int causal, int window) {
  if (q0 + BQ > S || k0 + BK > S) return false;
  if (causal && q0 < k0 + BK - 1) return false;
  if (window >= 0 && q0 + BQ - 1 - k0 >= window) return false;
  return true;
}

// x = s * scale + mask over an accumulator tile of N columns: entry
// 4 c + 2 i + e is row row0 + 8 i, column col0 + 8 c + 2 t4 + e (rows are
// query rows, or keys when KEY_ROWS).  Where the tile is open the mask is
// skipped, in a second instantiation rather than a branch an entry.  A
// tile holding rows or keys past S is never open, so their entries take
// -1e30 and, with their lse read as 0, p = exp(-1e30) = 0 exactly.
template <int N, bool KEY_ROWS, bool MASKED>
__device__ __forceinline__ void scale_scores_(float (&x)[N / 2], float scale,
                                              int row0, int col0, int t4,
                                              int S, int causal, int window) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = __fmul_rn(x[4 * c + 2 * i + e], scale);
        if (MASKED) {
          const int r = row0 + 8 * i, k = col0 + 8 * c + 2 * t4 + e;
          v = __fadd_rn(v, KEY_ROWS ? mask(k, r, S, causal, window)
                                    : mask(r, k, S, causal, window));
        }
        x[4 * c + 2 * i + e] = v;
      }
}

template <int N, bool KEY_ROWS>
__device__ __forceinline__ void scale_scores(float (&x)[N / 2], bool open,
                                             float scale, int row0, int col0,
                                             int t4, int S, int causal,
                                             int window) {
  if (open)
    scale_scores_<N, KEY_ROWS, false>(x, scale, row0, col0, t4, S, causal,
                                      window);
  else
    scale_scores_<N, KEY_ROWS, true>(x, scale, row0, col0, t4, S, causal,
                                     window);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A thread's two columns of 8-column chunk c, 8 c + 2 t4 and the next,
// of a row of `dim` columns: both as one bf16x2, or only those below dim
// (a head dim run at a wider compiled one stores no padding column).
// The address is formed term by term, so a constant c stays an immediate
// offset of the store.
__device__ __forceinline__ void store_cols(__nv_bfloat16* row, int c, int t4,
                                           int dim, float a, float b) {
  const int col = 8 * c + 2 * t4;
  if (col + 1 < dim)
    store_bf16x2(row + 8 * c + 2 * t4, a, b);
  else if (col < dim)
    row[8 * c + 2 * t4] = __float2bfloat16_rn(a);
}

// The true head dim that a kernel compiled at D sees: `dim` above D 128
// (129-256 run at 160 or 256), D itself up to 128, where the route runs
// only whole head dims, so the column guards fold away when it compiles.
template <int D>
__device__ __forceinline__ int true_dim(int dim) {
  return D > 128 ? dim : D;
}

// -- host: tensor maps ---------------------------------------------------

// The tensor map of a (batch, heads, S, dim) bf16 operand with (batch,
// head, row) strides `st` in elements, read in boxes of `rows` rows x
// min(D, 64) columns with the tile's swizzle (D the compiled head dim,
// dim <= D the true one); rows past S and columns past dim read as
// zeros.  A dim of size 1 is never stepped, so its stride is replaced by
// one TMA accepts (any multiple of 16 bytes).  Returns a cudaError_t
// value.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, Strides st, int batch,
             int heads, int S, int rows, int dim) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long any_b = Tile<D>::DP * 2;
  const long long row_b = S > 1 ? st.s * 2 : any_b;
  const long long head_b = heads > 1 ? st.h * 2 : any_b;
  const long long batch_b = batch > 1 ? st.b * 2 : any_b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_b),
                                 static_cast<cuuint64_t>(head_b),
                                 static_cast<cuuint64_t>(batch_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::PW),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<D>::SWIZZLE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc
}  // namespace flash

// Instantiate `FN<D>(args...)` for the head dims of the tc route: 16, 32,
// 64 and 128 as they are, 129-160 at 160 and 161-256 at 256 (the columns
// past the true head dim zero-filled by TMA and never stored).
#define FLASH_TC_DISPATCH_D(D, FN, ...)                 \
  switch (D) {                                          \
    case 16:                                            \
      return FN<16>(__VA_ARGS__);                       \
    case 32:                                            \
      return FN<32>(__VA_ARGS__);                       \
    case 64:                                            \
      return FN<64>(__VA_ARGS__);                       \
    case 128:                                           \
      return FN<128>(__VA_ARGS__);                      \
    default:                                            \
      if (D > 128 && D <= 160) return FN<160>(__VA_ARGS__); \
      if (D > 160 && D <= 256) return FN<256>(__VA_ARGS__); \
      return static_cast<int>(cudaErrorInvalidValue);   \
  }
