// Speculative proposal batteries of the free-running CGGibbs pass, for
// Hopper (sm_90a).  One templated kernel serves the three TPU kernels of
// mcmcglm_tpu/ops/freerun_batteries.py:
//
//   battery_sums          <- build_battery  ("pallas"):  lsum only
//   battery_commit        <- build_battery2 ("pallas2"): + decision replay
//                                                         and eta commit
//   battery_gather_commit <- build_battery3 ("pallas3"): + the X^T row
//                                                         gather Xt[j_c]
//
// For chain c and proposal k < K (K <= 32):
//
//   lsum[c,k] = sum_i  m_i != 0 ? ld(eta[c,i] + x[c,i] * delta[c,k], y_i) * m_i : 0
//
// with ld the relative log density of one built-in family/link pair (a
// compile-time FAM id from families.cuh; the Python side keeps the table of
// ids).  With the gather, the X^T rows are float32 or bfloat16 (the
// x_storage="bf16" row stream of build_battery3): a bf16 row is upcast in
// registers, exactly, and every product is then float32.  The mask
// is applied by selection, not multiplication, as the TPU kernels do, so a
// non-finite density at a zero-weight observation cannot leak into a sum.
// With COMMIT, thread 0 replays the first-acceptor decision from the very
// lsum values it stores: f_k = (lsum_k - ld0) + fprior_k, the first k with
// f_k >= level and k < rem, delta* = that delta when the gate is set and
// some k accepts, else 0; then every thread writes eta + x * delta*.  The
// automaton on the host side re-decides from the returned lsum with the
// same float operations, so both decisions agree bitwise.
//
// Design: one block per chain, 256 threads striding over the n
// observations (coalesced loads, the ragged edge masked by the loop bound,
// so no padding), K per-thread partial sums in registers (the loop over
// KMAX is unrolled and guarded by the runtime K, which keeps the sums out
// of local memory), then a block reduction by warp shuffles and shared
// memory in a fixed order: no atomics, so the sums repeat bitwise from run
// to run.  Products and sums that the PyTorch reference rounds separately
// are written with __fmul_rn / __fadd_rn so that nvcc cannot contract them
// into an FMA: the committed eta then equals the plain version bitwise.
//
// What bounds it on an H100: at the main path's C=256, n=10,000, K=4 one
// pass streams eta and the X^T rows in and eta_new out, about 3 x 10 MB
// (~10 us at 3.35 TB/s), against about 10 M log-density evaluations, each
// an expf and a log1pf (~40 M transcendental instructions, roughly
// comparable time).  The kernel is simple on purpose: this is the first,
// correct version; making it fast (more chains per block, vector loads,
// overlapping the second read of the row) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "families.cuh"

namespace {

using namespace mcmcglm;

constexpr int KMAX = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int FAM, bool GATHER, bool COMMIT, typename XT>
__global__ void __launch_bounds__(THREADS)
battery_kernel(const float* __restrict__ eta,     // (C, n)
               const XT* __restrict__ xsrc,       // (C, n) rows, or Xt (d, n)
               const int32_t* __restrict__ jidx,  // (C,) with GATHER
               int d,                             // rows of Xt with GATHER
               const float* __restrict__ deltas,  // (C, K)
               const float* __restrict__ fprior,  // (C, K) with COMMIT
               const float* __restrict__ scal,    // (C, 4) with COMMIT
               const float* __restrict__ y,       // (n,)
               const float* __restrict__ m,       // (n,) weights / mask
               float* __restrict__ lsum,          // (C, K)
               float* __restrict__ eta_new,       // (C, n) with COMMIT
               int n, int K, float param) {
  __shared__ float s_delta[KMAX];
  __shared__ float s_part[WARPS][KMAX];
  __shared__ float s_dstar;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* er = eta + (size_t)c * n;
  const XT* xr;
  bool row_ok = true;
  if (GATHER) {
    const int j = jidx[c];
    row_ok = j >= 0 && j < d;
    xr = xsrc + (size_t)(row_ok ? j : 0) * n;
  } else {
    xr = xsrc + (size_t)c * n;
  }
  if (tid < K) s_delta[tid] = deltas[(size_t)c * K + tid];
  __syncthreads();

  float acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;

  for (int i = tid; i < n; i += THREADS) {
    const float e0 = er[i];
    const float x = to_f32(xr[i]);
    const float yv = y[i];
    const float mv = m[i];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float e = __fadd_rn(e0, __fmul_rn(x, s_delta[k]));
        const float ld = ld_rel<FAM>(e, yv, param);
        acc[k] = __fadd_rn(acc[k], mv != 0.f ? __fmul_rn(ld, mv) : 0.f);
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) s_part[warp][k] = v;
    }
  }
  __syncthreads();

  if (tid == 0) {
    // one thread sums the warp partials in a fixed order, stores lsum and
    // decides from exactly the stored values
    const float nan = __int_as_float(0x7fc00000);
    float level = 0.f, ld0 = 0.f, gate = 0.f, rem = 0.f;
    if (COMMIT) {
      level = scal[(size_t)c * 4 + 0];
      ld0 = scal[(size_t)c * 4 + 1];
      gate = scal[(size_t)c * 4 + 2];
      rem = scal[(size_t)c * 4 + 3];
    }
    float dstar = 0.f;
    bool found = false;
    for (int k = 0; k < K; ++k) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, s_part[w][k]);
      if (!row_ok) t = nan;  // a bad coordinate index poisons the sums
      lsum[(size_t)c * K + k] = t;
      if (COMMIT && !found) {
        const float f = __fadd_rn(__fsub_rn(t, ld0), fprior[(size_t)c * K + k]);
        if (f >= level && (float)k < rem) {
          found = true;
          dstar = s_delta[k];
        }
      }
    }
    s_dstar = (gate > 0.f && found) ? dstar : 0.f;
  }

  if (COMMIT) {
    __syncthreads();
    const float ds = s_dstar;
    float* out = eta_new + (size_t)c * n;
    for (int i = tid; i < n; i += THREADS)
      out[i] = __fadd_rn(er[i], __fmul_rn(to_f32(xr[i]), ds));
  }
}

template <bool GATHER, bool COMMIT, typename XT = float>
int launch(int fam, const float* eta, const XT* xsrc, const int32_t* jidx,
           int d, const float* deltas, const float* fprior, const float* scal,
           const float* y, const float* m, float* lsum, float* eta_new,
           int C, int n, int K, float param, void* stream) {
  if (C < 1 || n < 1 || K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(C), block(THREADS);
#define MCMCGLM_BATTERY_CASE(F)                                             \
  case F:                                                                   \
    battery_kernel<F, GATHER, COMMIT, XT><<<grid, block, 0, s>>>(           \
        eta, xsrc, jidx, d, deltas, fprior, scal, y, m, lsum, eta_new, n,   \
        K, param);                                                          \
    break;
  switch (fam) {
    MCMCGLM_FOR_EACH_FAMILY(MCMCGLM_BATTERY_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MCMCGLM_BATTERY_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each returns
// cudaGetLastError() after the launch (0 on success).  Pointers are device
// pointers to contiguous float32 (int32 for j) tensors; the launch goes on
// the given stream and does not synchronise.

// replaces mcmcglm_tpu/ops/freerun_batteries.py::build_battery
extern "C" int battery_sums(const float* eta, const float* xg,
                            const float* deltas, const float* y,
                            const float* m, float* lsum, int C, int n, int K,
                            int fam, float param, void* stream) {
  return launch<false, false>(fam, eta, xg, nullptr, 0, deltas, nullptr,
                              nullptr, y, m, lsum, nullptr, C, n, K, param,
                              stream);
}

// replaces mcmcglm_tpu/ops/freerun_batteries.py::build_battery2
extern "C" int battery_commit(const float* eta, const float* xg,
                              const float* deltas, const float* fprior,
                              const float* scal, const float* y,
                              const float* m, float* lsum, float* eta_new,
                              int C, int n, int K, int fam, float param,
                              void* stream) {
  return launch<false, true>(fam, eta, xg, nullptr, 0, deltas, fprior, scal,
                             y, m, lsum, eta_new, C, n, K, param, stream);
}

// replaces mcmcglm_tpu/ops/freerun_batteries.py::build_battery3
extern "C" int battery_gather_commit(const int32_t* j, const float* Xt, int d,
                                     const float* eta, const float* deltas,
                                     const float* fprior, const float* scal,
                                     const float* y, const float* m,
                                     float* lsum, float* eta_new, int C,
                                     int n, int K, int fam, float param,
                                     void* stream) {
  return launch<true, true>(fam, eta, Xt, j, d, deltas, fprior, scal, y, m,
                            lsum, eta_new, C, n, K, param, stream);
}

// build_battery3 with x_storage="bf16": the same kernel on bfloat16 X^T rows
extern "C" int battery_gather_commit_bf16(const int32_t* j,
                                          const __nv_bfloat16* Xt, int d,
                                          const float* eta,
                                          const float* deltas,
                                          const float* fprior,
                                          const float* scal, const float* y,
                                          const float* m, float* lsum,
                                          float* eta_new, int C, int n, int K,
                                          int fam, float param,
                                          void* stream) {
  return launch<true, true, __nv_bfloat16>(fam, eta, Xt, j, d, deltas,
                                           fprior, scal, y, m, lsum, eta_new,
                                           C, n, K, param, stream);
}
