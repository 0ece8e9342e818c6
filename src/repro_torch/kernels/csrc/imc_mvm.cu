// The paper's switched-capacitor IMC projection (Eq. 6) as a tiled product:
// y[m, n] = (sum_k x[m, k] * (codes[k, n] - 1.5)) * scale[n] / K.
//
// Replaces the TPU kernel imc_mvm_pallas
// (src/repro/kernels/imc_mvm/imc_mvm.py:58, body _imc_kernel :35), whose
// grid (M/bm, N/bn, K/bk) carries an fp32 accumulator in VMEM scratch over
// the sequential K axis and applies the per-column scale and 1/K in the
// epilogue; its wrapper pads every axis to whole tiles and rescales by
// Kp/K.  Here the ragged edges are masked or zero-filled (a missing x entry
// adds an exact 0), so there is no padding and no Kp/K rescale: the
// epilogue multiplies by the column's scale and divides by the true K.
//
// Every term x * (c - 1.5) of binary x is a multiple of 0.5, so the fp32
// sum is exact in any order while K * 1.5 < 2^24; the only rounding is the
// epilogue's, the same on both routes, so they agree bit for bit.
//
// Bound: bytes at the skinny M of RNN inference (the codes are read once,
// as int8); at M 4096, K = N = 1024 x and y in fp32 (34.6 MB, 10.3 us)
// and the product's 8.6 GFLOP at the bf16 tensor-core rate (8.7 us) are
// close.  Two routes, chosen by the wrapper (ops.route):
//
// tc (K % 4 == 0, N % 16 == 0, 16-byte-aligned operands: what TMA can
// address).  x in {0, 1} and the levels {+-0.5, +-1.5} are exact in bf16,
// so the product runs on wgmma m64n256k16, bf16 x bf16 -> fp32.  A CTA of
// two warpgroups owns a 128 x 256 output tile (one wave of 128 CTAs at
// 4096 x 1024) and walks K in steps of 32 through a ring of four stages:
// thread 0 keeps three steps of TMA loads in flight (x as fp32 boxes of
// 128 rows x 32, codes as int8 boxes of 32 rows x 128, both with the
// 128-byte swizzle, rows and columns past the operand zero-filled; a zero
// code's level -1.5 meets only zero-filled x or an output column that is
// never stored).  Each step the 256 threads widen the codes into a
// swizzled bf16 level tile (four N-major panels of 64 columns; two tiles
// alternate) with two integer ops and one bf16x2 FMA per four codes,
// and each warpgroup reads its A fragments of x straight from the fp32
// tile (conflict-free under the swizzle), packs them to bf16x2 in
// registers (so x never makes a bf16 copy in memory) and issues the step's
// two wgmmas; the next step's codes are widened while they run.  The
// 128 x 256 tile takes 128 fp32 accumulators a thread.  The epilogue adds
// +0 (the tensor cores may leave -0 where the CUDA-core sum is +0), scales
// as the simt route does, stages the tile in the freed ring with the
// 128-byte swizzle and writes it with TMA stores, which skip rows and
// columns past y.  Smaller tiles would re-widen the codes more often (the
// widening is paid once per 128 rows) or re-read x more often; a 256-row
// tile would need 256 accumulators a thread.  Non-binary x is rounded to
// bf16 on this route (outside the op's domain; the wrapper documents it),
// and a code's low two bits select its level (codes are 2 b).
//
// simt (any other shape or alignment).  One block of 256 threads owns a
// 64 x 64 output tile and walks K in steps of 16: the x tile and the
// codes tile (turned into the levels c - 1.5 as they are staged) go to
// shared memory with scalar loads, and each thread accumulates a 4 x 4
// register tile in fp32 on the CUDA cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace imc_mvm {

// -- simt route ----------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    imc_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int N) {
  __shared__ float xs[kBK][kBM + 1];   // x tile, transposed (padded row)
  __shared__ float ws[kBK][kBN];   // levels c - 1.5
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 16 x 16 threads, 4 x 4 each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i - mm * kBK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < K) ? x[static_cast<int64_t>(m) * K + k]
                                    : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, nn = i - kk * kBN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N)
          ? static_cast<float>(codes[static_cast<int64_t>(k) * N + n]) - 1.5f
          : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty * 4 + i];
        b[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float kf = static_cast<float>(K);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[static_cast<int64_t>(m) * N + n] = acc[i][j] * scale[n] / kf;
    }
  }
}

// -- tc route ------------------------------------------------------------

namespace tc {

using namespace ::sm90;

constexpr int kBM = 128, kBN = 256, kBK = 32, kStages = 4, kThreads = 256;
constexpr int kXBytes = kBM * kBK * 4;      // x: one box of 128 rows x 128 B
constexpr int kCBytes = kBK * kBN;          // codes: two boxes of 32 x 128 B
constexpr int kPanel = kBK * 128;           // levels: 64 columns x kBK rows
constexpr int kBBytes = 4 * kPanel;         // one level tile, four panels
constexpr int kXOff = 0;
constexpr int kCOff = kXOff + kStages * kXBytes;
constexpr int kBOff = kCOff + kStages * kCBytes;
constexpr int kTiles = kBOff + 2 * kBBytes;
constexpr int kYBox = kBM * 128;            // output: 8 boxes of 128 x 32
static_assert(8 * kYBox <= kTiles, "the output tile reuses the ring");
constexpr int kSmem = kTiles + 1024;        // + alignment of the base

// d (64 x 256) += A.B: A (64 x 16 bf16) in registers, B N-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void mma_256(float (&d)[128],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Keep the A fragment of an in-flight wgmma in its registers until the
// wait (wgmma reads them asynchronously).
__device__ __forceinline__ void keep(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r]));
}

// Four 2 b codes (the low two bits of each byte of w) -> their levels
// c - 1.5 as two bf16x2 (lower columns in the low halves): the bf16 with
// bits 0x3F80 | c << 5 is 1 + c/4, and (1 + c/4) * 4 - 5.5 = c - 1.5 is
// exact.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t t = ((w << 5) & 0x60606060u) | 0x80808080u;
  const __nv_bfloat162 four = __floats2bfloat162_rn(4.0f, 4.0f);
  const __nv_bfloat162 off = __floats2bfloat162_rn(-5.5f, -5.5f);
  uint32_t u0 = __byte_perm(t, 0x3F3F3F3Fu, 0x4140);
  uint32_t u1 = __byte_perm(t, 0x3F3F3F3Fu, 0x4342);
  const __nv_bfloat162 v0 = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&u0),
                                    four, off);
  const __nv_bfloat162 v1 = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&u1),
                                    four, off);
  lo = *reinterpret_cast<const uint32_t*>(&v0);
  hi = *reinterpret_cast<const uint32_t*>(&v1);
}

// The codes of one ring stage (kBK rows x kBN int8, two swizzled boxes of
// 128 columns) -> a level tile (four swizzled N-major panels of 64 bf16
// columns).  Thread (k, seg) widens 16 codes of row k twice; eight
// neighbouring threads take eight rows, so both the reads and the writes
// of a quarter warp fall on eight distinct 16-byte bank groups.
__device__ __forceinline__ void widen_tile(uint32_t codes, uint32_t levels,
                                           int tid) {
  const int k = tid % kBK, sw = k % 8;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int seg = tid / kBK + 8 * s;   // 16 columns: 16 seg .. 16 seg + 15
    uint4 c;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(c.x), "=r"(c.y), "=r"(c.z), "=r"(c.w)
                 : "r"(codes + (seg / 8) * (kBK * 128) + k * 128 +
                       (((seg % 8) ^ sw) << 4)));
    uint32_t l[8];
    widen4(c.x, l[0], l[1]);
    widen4(c.y, l[2], l[3]);
    widen4(c.z, l[4], l[5]);
    widen4(c.w, l[6], l[7]);
    const uint32_t row = levels + (seg / 4) * kPanel + k * 128;
    const int chunk = 2 * (seg % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       row + (((chunk + h) ^ sw) << 4)),
                   "r"(l[4 * h]), "r"(l[4 * h + 1]), "r"(l[4 * h + 2]),
                   "r"(l[4 * h + 3])
                   : "memory");
  }
}

// x (fp32, one swizzled box of 128 rows x 32) -> the bf16 A fragments of
// the step's two k16 slices for this thread's rows r and r + 8.
__device__ __forceinline__ void load_a(uint32_t xs, int r, int t4,
                                       uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r + 8 * (q & 1);
      const int col = 16 * kk + 8 * (q >> 1) + 2 * t4;
      float2 v;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(v.x), "=f"(v.y)
                   : "r"(xs + row * 128 + (((col / 4) ^ (row % 8)) << 4) +
                         (col % 4) * 4));
      const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
      a[kk][q] = *reinterpret_cast<const uint32_t*>(&h);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
    imc_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap cmap,
                  const __grid_constant__ CUtensorMap ymap,
                  const float* __restrict__ scale, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t base = smem_base(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int steps = (K + kBK - 1) / kBK;

  auto xs = [&](int s) { return base + kXOff + s * kXBytes; };
  auto cs = [&](int s) { return base + kCOff + s * kCBytes; };
  auto bs = [&](int j) { return base + kBOff + j * kBBytes; };
  auto issue = [&](int t) {
    const int s = t % kStages;
    mbar_expect(&full[s], kXBytes + kCBytes);
    tma_load_2d(xs(s), &xmap, &full[s], t * kBK, m0);
    tma_load_2d(cs(s), &cmap, &full[s], n0, t * kBK);
    tma_load_2d(cs(s) + kBK * 128, &cmap, &full[s], n0 + 128, t * kBK);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < kStages && t < steps; ++t) issue(t);

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r = 64 * wg + 16 * warp + lane / 4, t4 = lane % 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  mbar_wait(&full[0], 0);
  widen_tile(cs(0), bs(0), tid);
  fence_async_smem();
  for (int t = 0; t < steps; ++t) {
    // the level tile of step t is complete; every thread has read x of
    // step t - 1 and waited for its wgmmas, so that stage may be refilled
    __syncthreads();
    if (tid == 0 && t > 0 && t - 1 + kStages < steps) issue(t - 1 + kStages);
    const int s = t % kStages;
    uint32_t a[2][4];
    load_a(xs(s), r, t4, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma_256(acc, a[kk], desc(bs(t & 1) + kk * 16 * 128, kPanel, 1024, 1),
              1);
    wg_commit();
    if (t + 1 < steps) {
      // the other level tile was last read by step t - 1's wgmmas, which
      // every warpgroup waited for before the barrier above
      mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
      widen_tile(cs((t + 1) % kStages), bs((t + 1) & 1), tid);
      fence_async_smem();
    }
    wg_wait();
    keep(a);
    fence_regs(acc);
  }
  __syncthreads();   // every wgmma and x read done: the ring is free

  // epilogue: y = (acc + 0) * scale / K into eight swizzled boxes of 128
  // rows x 32 columns, then TMA stores (rows and columns past y skipped)
  const float kf = static_cast<float>(K);
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = 8 * c + 2 * t4, n = n0 + col;
    const float s0 = n < N ? scale[n] : 0.0f;    // N % 16 == 0: n + 1 too
    const float s1 = n < N ? scale[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 8 * i;
      const float y0 = __fadd_rn(acc[4 * c + 2 * i], 0.0f) * s0 / kf;
      const float y1 = __fadd_rn(acc[4 * c + 2 * i + 1], 0.0f) * s1 / kf;
      const int cc = col % 32;
      const uint32_t dst = base + (col / 32) * kYBox + row * 128 +
                           (((cc / 4) ^ (row % 8)) << 4) + (cc % 4) * 4;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(dst), "f"(y0),
                   "f"(y1)
                   : "memory");
    }
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int b = 0; b < kBN / 32 && n0 + 32 * b < N; ++b)
      tma_store_2d(&ymap, base + b * kYBox, n0 + 32 * b, m0);
    tma_store_drain();
  }
}

// The tensor map of a row-major (rows, cols) operand of `elem` bytes read
// or written in boxes of box_rows x box_cols with the 128-byte swizzle.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
             const void* ptr, int rows, int cols, int box_rows, int box_cols,
             CUtensorMapL2promotion promo) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, promo,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch(const void* x, const void* codes, const void* scale, void* out,
           int M, int K, int N, cudaStream_t stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (M < 1 || K < 1 || N < 1 || K % 4 || N % 16 || misaligned(x) ||
      misaligned(codes) || misaligned(out) || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, cmap, ymap;
  int err = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, M, K, kBM,
                     32, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (!err)
    err = make_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, K, N, kBK,
                   128, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (!err)
    err = make_map(&ymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, M, N, kBM,
                   32, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (err) return err;
  // on every launch: the attribute belongs to the current device's
  // context, and a host-side call costs less than a microsecond
  const cudaError_t e = cudaFuncSetAttribute(
      imc_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  imc_tc_kernel<<<grid, kThreads, kSmem, stream>>>(
      xmap, cmap, ymap, static_cast<const float*>(scale), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace imc_mvm

extern "C" int imc_mvm_f32(const void* x, const void* codes,
                           const void* scale, void* out, int M, int K, int N,
                           void* stream) {
  const dim3 grid((N + imc_mvm::kBN - 1) / imc_mvm::kBN,
                  (M + imc_mvm::kBM - 1) / imc_mvm::kBM);
  imc_mvm::imc_kernel<<<grid, imc_mvm::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The tc route; cudaErrorInvalidValue for a shape or alignment it does
// not take (ops.route says which).
extern "C" int imc_mvm_f32_tc(const void* x, const void* codes,
                              const void* scale, void* out, int M, int K,
                              int N, void* stream) {
  return imc_mvm::tc::launch(x, codes, scale, out, M, K, N,
                             static_cast<cudaStream_t>(stream));
}
