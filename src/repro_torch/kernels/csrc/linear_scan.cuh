// What linear_scan.cu and linear_scan_bwd.cu share: the chunked layout of
// a block, vector loads and stores, and the launch shape.
//
// Layout.  Tensors are (B, T, D), contiguous.  A block owns one batch row
// (blockIdx.y) and a slab of cw * V channels (blockIdx.x); its threads
// are cw channel lanes by nw time chunks (threadIdx.x = w * cw + lane),
// and a thread holds V neighbouring channels of L consecutive steps in
// registers.  The block walks T in tiles of nw * L steps; a carry passes
// from one tile to the next in registers.  Neighbouring lanes read
// neighbouring V-element vectors of one step, so each step of a chunk is
// one contiguous run of cw * V elements (32 bytes or more).
//
// Within a tile every chunk first folds its steps from a zero carry into
// an affine summary (P, Q): carry_out = P * carry_in + Q.  The summaries
// meet in shared memory (two buffers, by tile parity, so one barrier a
// tile), each thread folds its predecessors' into its incoming carry (a
// short serial scan over nw entries, which also yields the tile's
// outgoing carry), and then re-walks its chunk from registers with the
// true carry.  Steps past T are the identity (a = 1, b = 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace scan {

// Steps a thread holds for V channels (L * V values of each array), by
// kernel: chosen on an H100 from a sweep of (V, L) at the path shapes
// (PERF.md, the scan redesign's findings): the forward best at 16 steps
// of one channel, the backward at 8 steps of four.
template <bool BWD, int V>
struct Chunk {
  static constexpr int L = BWD ? (V == 2 ? 16 : 8) : (V == 1 ? 16 : 8);
};

// Threads a block: 512 for one tile, 256 for a prefetching kernel (which
// holds the next tile's values beside this one's), whose register limit
// so rises from 128 to 255.  One tile's kernels keep the 128 limit even
// where they would use more: the backward's 8 x 4 chunk ran faster so,
// at four blocks of 128 threads an SM, than with 162 registers and three
// (PERF.md).
__host__ __device__ constexpr int max_threads(bool pf) {
  return pf ? 256 : 512;
}

template <int BYTES>
struct Bits;
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<16> {
  using type = uint4;
};

// An element's bits and its conversions to and from fp32.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using bits = float;
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float get(unsigned short x) {
    return __bfloat162float(__ushort_as_bfloat16(x));
  }
  static __device__ __forceinline__ unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  // round to bf16 and back: the value the reference holds
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// V neighbouring elements at p (aligned to V * sizeof(T)) as fp32: one
// load of V * sizeof(T) bytes.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  using W = typename Bits<V * sizeof(T)>::type;
  const W w = *reinterpret_cast<const W*>(p);
  typename Elem<T>::bits e[V];
  memcpy(e, &w, sizeof(W));
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = Elem<T>::get(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using W = typename Bits<V * sizeof(T)>::type;
  typename Elem<T>::bits e[V];
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = Elem<T>::put(v[i]);
  W w;
  memcpy(&w, e, sizeof(W));
  *reinterpret_cast<W*>(p) = w;
}

// The launch shape of a (B, T, D) scan: V channels a thread, cw lanes by
// nw chunks a block, tiles of nw * L steps.
struct Shape {
  int vec, cw, nw, tiles, slabs;
};

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

inline int chunk_len(bool bwd, int vec) {
  if (bwd)
    return vec == 4 ? Chunk<true, 4>::L
                    : vec == 2 ? Chunk<true, 2>::L : Chunk<true, 1>::L;
  return vec == 4 ? Chunk<false, 4>::L
                  : vec == 2 ? Chunk<false, 2>::L : Chunk<false, 1>::L;
}

// The widest vector (4, 2, 1 elements) that divides D, suits every base
// address (`addr`: the bases OR-ed) and still gives the kernel enough
// threads (the forward about 1024 an SM, the backward, whose threads
// hold three arrays, 256); then the most lanes a block that still give
// two blocks an SM, but never under 32 bytes of a step a chunk; then as
// many chunks as cover T in whole warps, or, past the block's thread
// limit, the prefetching shape of 256 threads walking several tiles.
inline Shape choose(bool bwd, int B, int steps, int D, int elt,
                    uintptr_t addr) {
  const int sms = sm_count();
  const long long want = (bwd ? 256LL : 1024LL) * sms;
  int vec = 1;
  for (int v = 4; v > 1; v /= 2) {
    const int L = chunk_len(bwd, v);
    const long long threads = static_cast<long long>(B) * (D / v) *
                              ((steps + L - 1) / L);
    if (D % v == 0 && addr % (v * elt) == 0 && threads >= want) {
      vec = v;
      break;
    }
  }
  const int L = chunk_len(bwd, vec);
  const int lanes = D / vec;
  const int cw_min = 32 / (vec * elt) > 1 ? 32 / (vec * elt) : 1;
  int cw = 32;
  while (cw > cw_min &&
         static_cast<long long>(B) * ((lanes + cw - 1) / cw) < 2LL * sms)
    cw /= 2;
  const int per_warp = 32 / cw;
  int nw = (steps + L - 1) / L;
  if (nw > max_threads(false) / cw) nw = max_threads(true) / cw;
  nw = (nw + per_warp - 1) / per_warp * per_warp;
  const int tile = nw * L;
  return Shape{vec, cw, nw, (steps + tile - 1) / tile,
               (lanes + cw - 1) / cw};
}

// Shared memory of a block: (P, Q) of every chunk's channels, twice.
inline size_t smem_bytes(const Shape& s) {
  return 4 * sizeof(float) * static_cast<size_t>(s.nw) * s.cw * s.vec;
}

// Call f(V, PF) with the shape's vector width and prefetch flag as
// compile-time constants (PF: the next tile's loads are issued before
// this tile's combine, when the block walks more than one tile).
template <typename F>
void with_shape(const Shape& s, F&& f) {
  using std::integral_constant;
  const bool pf = s.tiles > 1;
  if (s.vec == 4) {
    if (pf) f(integral_constant<int, 4>{}, std::true_type{});
    else f(integral_constant<int, 4>{}, std::false_type{});
  } else if (s.vec == 2) {
    if (pf) f(integral_constant<int, 2>{}, std::true_type{});
    else f(integral_constant<int, 2>{}, std::false_type{});
  } else {
    if (pf) f(integral_constant<int, 1>{}, std::true_type{});
    else f(integral_constant<int, 1>{}, std::false_type{});
  }
}

}  // namespace scan

