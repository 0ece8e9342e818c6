// Adjoint of the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t over
// axis 1 of (B, T, D) tensors.  Given a, the forward output h, h0 and the
// cotangent g of h, it walks time backwards:
//
//   lambda_t = g_t + a_{t+1} * lambda_{t+1}      (a_T = 0)
//   db_t = lambda_t,  da_t = lambda_t * h_{t-1}  (h_{-1} = h0),
//   dh0 = a_0 * lambda_0
//
// Replaces the reference's backward (src/repro/kernels/linear_scan/ops.py:66
// _bwd), which reruns the TPU kernel linear_scan_pallas
// (linear_scan.py:54) on time-flipped, shifted inputs and then forms da,
// db and dh0 in separate XLA ops.  Here one pass does all of it.
//
// Rounding contract with the reference: lambda carries in fp32 and is
// rounded to the input type before it is stored as db; da and dh0 are the
// products of that rounded lambda with h_{t-1} and a_0, rounded once (the
// reference stores lambda as its scan's output in the input type and
// multiplies afterwards; a product of two bf16 values is exact in fp32).
//
// Bound: memory.  It reads a, g, h once and writes da, db once: 5*B*T*D
// elements plus 2*B*D for h0 and dh0.  At the LM training shape
// (8, 256, 960) bf16 that is 19.7 MB, 5.9 us at 3.35 TB/s.
//
// Design: the forward's chunked scan (linear_scan.cuh) in reverse time.
// The first design gave one thread a channel and walked T in it, with
// ptxas interleaving each group's loads with its stores so that about
// two loads were in flight a step.  Here a thread issues every load of
// its L steps (a, g and h_{t-1}, V elements a load) before its first
// FMA.  The carry between chunks is mu = a_{t1} * lambda_{t1}, what the
// chunk [t0, t1) receives from the step after it; a chunk maps it as
// mu_out = P * mu_in + Q with P = prod a_t and Q = a_{t0} * lambda_{t0}
// from mu_in = 0.  The chunks of a tile combine these from the last
// backwards through shared memory, then each re-walks its steps with its
// true mu, writing db, da and (the chunk holding t = 0) dh0.  Tiles of T
// are walked from the last; where there are several, the previous
// tile's loads are issued before this tile's combine.  At the training
// shape (8, 256, 960) bf16 that is 480 blocks of 128 threads, each 8
// steps of four channels (8-byte loads), one tile each.
#include "linear_scan.cuh"

namespace {

template <typename T, int V, bool PF>
__global__ void __launch_bounds__(scan::max_threads(PF))
    linear_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ g,
                           const T* __restrict__ h, const T* __restrict__ h0,
                           T* __restrict__ da, T* __restrict__ db,
                           T* __restrict__ dh0, int steps, int D, int cw) {
  constexpr int L = scan::Chunk<true, V>::L;
  extern __shared__ float summ[];  // [2 tiles][P, Q][nw][cw][V]
  const int nw = blockDim.x / cw;
  const int lane = threadIdx.x % cw, w = threadIdx.x / cw;
  const int d = (blockIdx.x * cw + lane) * V;
  const bool on = d < D;
  const int64_t row = blockIdx.y;
  const int64_t base = row * steps * D + d;
  const T* h_init = h0 + row * D + d;
  const int tile = nw * L;
  const int n_tiles = (steps + tile - 1) / tile;
  const int slots = nw * cw * V;
  const int mine = (w * cw + lane) * V;

  // a_t, g_t and h_{t-1} of steps t0 .. t0 + L - 1 (past T or D: a = 1,
  // g = 0, which pass lambda through unchanged)
  auto load = [&](int t0, float (&av)[L][V], float (&gv)[L][V],
                  float (&hv)[L][V]) {
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int t = t0 + u;
      if (on && t < steps) {
        const int64_t off = base + static_cast<int64_t>(t) * D;
        scan::load_vec<T, V>(a + off, av[u]);
        scan::load_vec<T, V>(g + off, gv[u]);
        scan::load_vec<T, V>(t > 0 ? h + off - D : h_init, hv[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          av[u][v] = 1.0f;
          gv[u][v] = 0.0f;
          hv[u][v] = 0.0f;
        }
      }
    }
  };

  float av[L][V], gv[L][V], hv[L][V];
  load((n_tiles - 1) * tile + w * L, av, gv, hv);
  float mu[V];  // a_{t1} * lambda_{t1} entering the tile from the right
#pragma unroll
  for (int v = 0; v < V; ++v) mu[v] = 0.0f;

  for (int it = n_tiles - 1; it >= 0; --it) {
    const int t0 = it * tile + w * L;
    float an[PF ? L : 1][V], gn[PF ? L : 1][V], hn[PF ? L : 1][V];
    if constexpr (PF) {
      if (it > 0) load(t0 - tile, an, gn, hn);
    }
    // this chunk's summary from mu = 0
    float* P = summ + (it & 1) * 2 * slots;
    float* Q = P + slots;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float lam = gv[L - 1][v], p = av[L - 1][v];
#pragma unroll
      for (int u = L - 2; u >= 0; --u) {
        lam = fmaf(av[u + 1][v], lam, gv[u][v]);
        p *= av[u][v];
      }
      P[mine + v] = p;
      Q[mine + v] = av[0][v] * lam;
    }
    __syncthreads();
    // mu entering this chunk: the tile's mu through chunks nw-1 .. w+1;
    // the walk over all nw chunks leaves the tile's outgoing mu
    float m[V] = {};
    for (int j = nw - 1; j >= 0; --j) {
      const int s = (j * cw + lane) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (j == w) m[v] = mu[v];
        mu[v] = fmaf(P[s + v], mu[v], Q[s + v]);
      }
    }
    // re-walk the chunk backwards with the true mu
    float lam[V], lr[V];
#pragma unroll
    for (int v = 0; v < V; ++v) lam[v] = gv[L - 1][v] + m[v];
#pragma unroll
    for (int u = L - 1; u >= 0; --u) {  // lam is lambda at step t0 + u
      float dav[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        lr[v] = scan::Elem<T>::round(lam[v]);
        dav[v] = lr[v] * hv[u][v];
      }
      const int t = t0 + u;
      if (on && t < steps) {
        const int64_t off = base + static_cast<int64_t>(t) * D;
        scan::store_vec<T, V>(db + off, lr);
        scan::store_vec<T, V>(da + off, dav);
      }
      if (u > 0) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          lam[v] = fmaf(av[u][v], lam[v], gv[u - 1][v]);
      }
    }
    if (t0 == 0 && on) {  // lr is lambda_0 rounded
      float dh[V];
#pragma unroll
      for (int v = 0; v < V; ++v) dh[v] = av[0][v] * lr[v];
      scan::store_vec<T, V>(dh0 + row * D + d, dh);
    }
    if (it > 0) {
      if constexpr (PF) {
#pragma unroll
        for (int u = 0; u < L; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            av[u][v] = an[u][v];
            gv[u][v] = gn[u][v];
            hv[u][v] = hn[u][v];
          }
      } else {
        load(t0 - tile, av, gv, hv);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* g, const void* h, const void* h0,
           void* da, void* db, void* dh0, int B, int steps, int D,
           void* stream) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(h0) |
      reinterpret_cast<uintptr_t>(da) | reinterpret_cast<uintptr_t>(db) |
      reinterpret_cast<uintptr_t>(dh0);
  const scan::Shape s =
      scan::choose(true, B, steps, D, sizeof(T), addr);
  const dim3 grid(s.slabs, B);
  const auto st = static_cast<cudaStream_t>(stream);
  scan::with_shape(s, [&](auto vec, auto pf) {
    linear_scan_bwd_kernel<T, decltype(vec)::value, decltype(pf)::value>
        <<<grid, s.cw * s.nw, scan::smem_bytes(s), st>>>(
            static_cast<const T*>(a), static_cast<const T*>(g),
            static_cast<const T*>(h), static_cast<const T*>(h0),
            static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dh0),
            steps, D, s.cw);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int linear_scan_bwd_f32(const void* a, const void* g,
                                   const void* h, const void* h0, void* da,
                                   void* db, void* dh0, int B, int steps,
                                   int D, void* stream) {
  return launch<float>(a, g, h, h0, da, db, dh0, B, steps, D, stream);
}

extern "C" int linear_scan_bwd_bf16(const void* a, const void* g,
                                    const void* h, const void* h0, void* da,
                                    void* db, void* dh0, int B, int steps,
                                    int D, void* stream) {
  return launch<__nv_bfloat16>(a, g, h, h0, da, db, dh0, B, steps, D,
                               stream);
}
