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
// Design: as the forward kernel — one thread per (b, d) channel, threads
// along d so a warp touches 32 neighbouring elements of one time step,
// lambda in a register for the whole sequence, and the time loop unrolled
// by kUnroll with every load of a group written before the dependent FMAs.
// Ragged D is masked.  With only B*D threads (7,680 at the LM shape) each
// walking T dependent steps it sits far from its bound, and further than
// the forward: ptxas interleaves this loop's 24 loads with its stores
// (SASS: LDG LDG FFMA STG LDG STG ...), so only about two loads are in
// flight per step.  Software-pipelining the loads across groups, then a
// chunked reverse scan across T, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// round to the storage type and back: the value the reference holds
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    linear_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ g,
                           const T* __restrict__ h, const T* __restrict__ h0,
                           T* __restrict__ da, T* __restrict__ db,
                           T* __restrict__ dh0, int steps, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * static_cast<int64_t>(steps) * D + d;
  const T* ap = a + base;
  const T* gp = g + base;
  const T* hp = h + base;
  T* dap = da + base;
  T* dbp = db + base;
  const float h_init = load_f(h0 + row * D + d);
  float lam = 0.0f;        // fp32 carry
  float a_next = 0.0f;     // a_{t+1}; a_T = 0
  float lam_r = 0.0f;      // lambda_0 rounded, for dh0
  int t = steps - 1;
  for (; t + 1 - kUnroll >= 1; t -= kUnroll) {
    // steps t, t-1, ..., t-kUnroll+1, all with t-u >= 1 (h_{t-u-1} in h)
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = static_cast<int64_t>(t - u) * D;
      av[u] = load_f(ap + off);
      gv[u] = load_f(gp + off);
      hv[u] = load_f(hp + off - D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = static_cast<int64_t>(t - u) * D;
      lam = fmaf(a_next, lam, gv[u]);
      lam_r = round_to(lam, dbp);
      store_f(dbp + off, lam_r);
      store_f(dap + off, lam_r * hv[u]);
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    const int64_t off = static_cast<int64_t>(t) * D;
    const float h_prev = t > 0 ? load_f(hp + off - D) : h_init;
    lam = fmaf(a_next, lam, load_f(gp + off));
    lam_r = round_to(lam, dbp);
    store_f(dbp + off, lam_r);
    store_f(dap + off, lam_r * h_prev);
    a_next = load_f(ap + off);
  }
  // a_next is a_0 and lam_r is lambda_0 rounded
  store_f(dh0 + row * D + d, a_next * lam_r);
}

template <typename T>
int launch(const void* a, const void* g, const void* h, const void* h0,
           void* da, void* db, void* dh0, int B, int steps, int D,
           void* stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  linear_scan_bwd_kernel<T><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<const T*>(h), static_cast<const T*>(h0),
      static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dh0), steps,
      D);
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
