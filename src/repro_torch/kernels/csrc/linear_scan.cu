// Diagonal linear recurrence  h_t = a_t * h_{t-1} + b_t  over axis 1 of
// (B, T, D) tensors, fp32 carry, output in the input type.
//
// Replaces the TPU kernel linear_scan_pallas
// (src/repro/kernels/linear_scan/linear_scan.py:54), which walks the time
// chunks of a (B, D/dblk, T/tblk) grid in order and carries h in VMEM.
//
// Bound: memory.  Each element of a and b is read once and each h written
// once (2 flops per 3 elements), so the least time is the bytes over the
// card's memory rate: 3*B*T*D*sizeof(T) for the main path.
//
// Design: a chunked scan across T (layout and combine in
// linear_scan.cuh).  The first design gave one thread a channel and
// walked all T steps in it: at the LM's prefill chunk (4, 256, 960) that
// was 3,840 threads waiting through 32 dependent load round trips.  Here
// a thread takes L steps of V channels, issues every load of its chunk
// (all a, then all b, V elements a load) before its first FMA, folds
// them into (P = prod a, Q = the chunk's end value from h = 0), and the
// block's chunks combine their summaries through shared memory before
// each re-walks its steps from registers with its true incoming h.  So a
// tile of T costs one load round trip, one barrier and two short FMA
// chains; the (4, 256, 960) chunk runs as 240 blocks of 256 threads of
// 16 steps, one tile each.  Where a block walks several tiles, the next
// tile's loads are issued before this tile's combine and the carry
// passes on in registers: falcon-mamba's (1, 2048, 131072) fp32 runs
// 1024 blocks of 256 threads, each 8 steps of four channels (16-byte
// loads), over 32 tiles.  Ragged D is masked, not padded.
#include "linear_scan.cuh"

namespace {

template <typename T, int V, bool PF>
__global__ void __launch_bounds__(scan::max_threads(PF))
    linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ h0, T* __restrict__ out,
                       int steps, int D, int cw) {
  constexpr int L = scan::Chunk<false, V>::L;
  extern __shared__ float summ[];  // [2 tiles][P, Q][nw][cw][V]
  const int nw = blockDim.x / cw;
  const int lane = threadIdx.x % cw, w = threadIdx.x / cw;
  const int d = (blockIdx.x * cw + lane) * V;
  const bool on = d < D;
  const int64_t row = blockIdx.y;
  const int64_t base = row * steps * D + d;
  const int tile = nw * L;
  const int n_tiles = (steps + tile - 1) / tile;
  const int slots = nw * cw * V;
  const int mine = (w * cw + lane) * V;

  // a and b of steps t0 .. t0 + L - 1 (the identity past T or D)
  auto load = [&](int t0, float (&av)[L][V], float (&bv)[L][V]) {
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int t = t0 + u;
      if (on && t < steps) {
        const int64_t off = base + static_cast<int64_t>(t) * D;
        scan::load_vec<T, V>(a + off, av[u]);
        scan::load_vec<T, V>(b + off, bv[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          av[u][v] = 1.0f;
          bv[u][v] = 0.0f;
        }
      }
    }
  };

  float av[L][V], bv[L][V];
  load(w * L, av, bv);
  float carry[V];  // h entering the tile, then leaving it
  if (on) {
    scan::load_vec<T, V>(h0 + row * D + d, carry);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) carry[v] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * tile + w * L;
    float an[PF ? L : 1][V], bn[PF ? L : 1][V];
    if constexpr (PF) {
      if (it + 1 < n_tiles) load(t0 + tile, an, bn);
    }
    // this chunk's summary from h = 0
    float* P = summ + (it & 1) * 2 * slots;
    float* Q = P + slots;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float p = 1.0f, q = 0.0f;
#pragma unroll
      for (int u = 0; u < L; ++u) {
        q = fmaf(av[u][v], q, bv[u][v]);
        p *= av[u][v];
      }
      P[mine + v] = p;
      Q[mine + v] = q;
    }
    __syncthreads();
    // h entering this chunk: the tile's carry through chunks 0 .. w-1;
    // the walk over all nw chunks leaves the tile's outgoing carry
    float h[V] = {};
    for (int j = 0; j < nw; ++j) {
      const int s = (j * cw + lane) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (j == w) h[v] = carry[v];
        carry[v] = fmaf(P[s + v], carry[v], Q[s + v]);
      }
    }
    // re-walk the chunk from registers with the true carry
#pragma unroll
    for (int u = 0; u < L; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(av[u][v], h[v], bv[u][v]);
      const int t = t0 + u;
      if (on && t < steps)
        scan::store_vec<T, V>(out + base + static_cast<int64_t>(t) * D, h);
    }
    if (it + 1 < n_tiles) {
      if constexpr (PF) {
#pragma unroll
        for (int u = 0; u < L; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            av[u][v] = an[u][v];
            bv[u][v] = bn[u][v];
          }
      } else {
        load(t0 + tile, av, bv);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, int B,
           int steps, int D, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(h0) |
                         reinterpret_cast<uintptr_t>(out);
  const scan::Shape s =
      scan::choose(false, B, steps, D, sizeof(T), addr);
  const dim3 grid(s.slabs, B);
  const auto st = static_cast<cudaStream_t>(stream);
  scan::with_shape(s, [&](auto vec, auto pf) {
    linear_scan_kernel<T, decltype(vec)::value, decltype(pf)::value>
        <<<grid, s.cw * s.nw, scan::smem_bytes(s), st>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<const T*>(h0), static_cast<T*>(out), steps, D,
            s.cw);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int linear_scan_f32(const void* a, const void* b, const void* h0,
                               void* out, int B, int steps, int D,
                               void* stream) {
  return launch<float>(a, b, h0, out, B, steps, D, stream);
}

extern "C" int linear_scan_bf16(const void* a, const void* b, const void* h0,
                                void* out, int B, int steps, int D,
                                void* stream) {
  return launch<__nv_bfloat16>(a, b, h0, out, B, steps, D, stream);
}
