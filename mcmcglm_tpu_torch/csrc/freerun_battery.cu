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
// compile-time FAM id from families.cuh, and for the composed route of
// the pairs without a path of their own, the runtime family and link ids
// in comp; the Python side keeps the table of ids).  With the gather, the
// X^T rows are float32 or bfloat16 (the x_storage="bf16" row stream of
// build_battery3): a bf16 row is upcast in
// registers, exactly, and every product is then float32.  The mask is
// applied by selection, not multiplication, as the TPU kernels do, so a
// non-finite density at a zero-weight observation cannot leak into a sum.
// With COMMIT the kernel replays the first-acceptor decision from the very
// lsum values it stores: f_k = (lsum_k - ld0) + fprior_k, the first k with
// f_k >= level and k < rem, delta* = that delta when the gate is set and
// some k accepts, else 0; then it writes eta + x * delta*.  The automaton
// on the host side re-decides from the returned lsum with the same float
// operations, so both decisions agree bitwise.
//
// What bounds it on an H100: at the main path's C=256, n=10,000, K=4
// (binomial/logit, X^T of d=1,000 rows) a pass must read eta and the
// gathered rows and write eta_new, about 31 MB (9.2 us at 3.35 TB/s), and
// evaluate 10.24 M log densities.  With CUDA's accurate expf and log1pf
// (the numerics of families.cuh, no fast-math substitutes) one evaluation
// needs about 39 instructions on their fall-through paths, with the
// predictor and the masked accumulation (counted in chip_smoke.py), about
// 12 us of issue at 132 SMs x 128 lanes x 1.98 GHz.  So the kernel is
// bound by instructions, with the bytes close behind: it has to keep every
// lane busy while the rows stream in, and the rows must not be read twice.
//
// Design: one thread-block cluster of CL <= 8 CTAs per chain (the portable
// limit), 128 threads each.  CTA r of the cluster owns a contiguous slice
// of the observations; CL is the fewest CTAs whose slices fit the register
// tile (7 at n=10,000: 1,792 CTAs, about 1.7 waves at 8 CTAs per SM), and a
// row longer than 8 tiles walks its slices in chunks.  Each thread loads
// its part of the slice, eta and the X row, into registers as 16-byte
// vectors (float4, or 4 bf16 in 8 bytes) before any arithmetic, so all of
// a warp's loads are in flight together: a tile of 3 units of 4
// observations per thread, 1,536 per CTA (the composed route: 1 unit, 512
// per CTA, 8 CTAs and 3 chunks a chain at n=10,000).  The kernel is held
// to 64 registers (8 CTAs per SM) without spills on the six pairs' own
// paths.  K is a template parameter (1,
// and 4, the main path's spec_k; one runtime-K instantiation walks the
// proposals in blocks of 4 over the same registers), so the accumulators
// stay in registers without dead copies of the density.  The reduction is
// fixed in order and has no atomics: each thread sums its own observations
// in order, a warp by shuffles, a CTA over its warps in order; after
// cluster.sync() warp 0 of every CTA reads the CL partials over
// distributed shared memory in rank order, one lane per proposal, all
// loads in flight at once.  Every CTA thus holds the same sums, bitwise;
// rank 0 stores them, and every CTA decides by a ballot over those lanes
// from exactly the floats rank 0 stores, so only one cluster barrier sits
// on the critical path.  Each CTA then commits its slice from the
// registers it loaded (no second read of eta or the row unless the slice
// took more than one chunk) between the two halves of a second cluster
// barrier, which keeps every CTA's shared memory alive until the others
// have read it.  The layout of observations over threads depends only on n
// (not on the launcher, the row type or the alignment), so the three
// launchers and the bf16 rows reduce in one and the same order, and the
// sums repeat bitwise.  Rows that are not 16-byte aligned (n % 4 != 0, or
// an offset pointer) take the same layout through scalar loads.  Products
// and sums that the PyTorch reference rounds separately are written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into an FMA: the
// committed eta then equals the plain version bitwise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "families.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mcmcglm;

constexpr int KMAX = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CTAS = 8;  // resident CTAs per SM: caps registers at 64
constexpr int G = 4;  // observations per unit: one 16-byte float4 of eta
// units per thread, the register tile: 3 for the six pairs with a path of
// their own; 1 for the composed route, whose kernels hold the unrolled
// body of each of its fifteen pairs, so that they stay a third as long and
// the tile leaves the registers to the longer densities
template <int FAM>
__host__ __device__ constexpr int tile_units() {
  return FAM == FAM_COMPOSED ? 1 : 3;
}
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int KB_RUNTIME = 4;  // proposals per block on the runtime-K path

// four consecutive row values, upcast to float32 (bf16 exactly: a bf16 is
// the top half of the float32 with the same value)
__device__ __forceinline__ void load4(const float* p, bool vec, int nv,
                                      float (&v)[G]) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = g < nv ? __ldg(p + g) : 0.f;
  }
}

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      int nv, float (&v)[G]) {
  if (vec) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = g < nv ? bf16_bits(__ldg(q + g)) : 0.f;
  }
}

// observations of unit v of this thread in [base, end): G or 0 on the
// vector path (its slices end on multiples of G), 0..G on the scalar path
__device__ __forceinline__ int unit_start(int base, int v) {
  return base + (v * THREADS + (int)threadIdx.x) * G;
}
__device__ __forceinline__ int unit_len(int i, int end) {
  return max(0, min(G, end - i));
}

template <int V, typename XT>
__device__ __forceinline__ void load_tile(const float* er, const XT* xr,
                                          int base, int end, bool vec,
                                          float (&e)[V][G], float (&x)[V][G]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = unit_start(base, v);
    const int nv = unit_len(i, end);
    if (nv > 0) {
      load4(er + i, vec, nv, e[v]);
      load4(xr + i, vec, nv, x[v]);
    }
  }
}

// acc[q] += the masked log densities ld of the tile at proposal kb * KB
// + q
template <int KB, int V, typename LD>
__device__ __forceinline__ void accumulate(const float (&e)[V][G],
                                           const float (&x)[V][G],
                                           const float* __restrict__ y,
                                           const float* __restrict__ m,
                                           int base, int end, bool vec,
                                           const float (&dl)[KB], int nk,
                                           LD ld, float (&acc)[KB]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = unit_start(base, v);
    const int nv = unit_len(i, end);
    if (nv == 0) continue;
    float yv[G], mv[G];
    load4(y + i, vec, nv, yv);
    load4(m + i, vec, nv, mv);  // zero weight past the slice's end
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        if (q >= nk) continue;
        const float ev = __fadd_rn(e[v][g], __fmul_rn(x[v][g], dl[q]));
        const float lv = ld(ev, yv[g]);
        acc[q] = __fadd_rn(acc[q],
                           mv[g] != 0.f ? __fmul_rn(lv, mv[g]) : 0.f);
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void store_tile(float* out, const float (&e)[V][G],
                                           const float (&x)[V][G], float ds,
                                           int base, int end, bool vec) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = unit_start(base, v);
    const int nv = unit_len(i, end);
    float o[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      o[g] = __fadd_rn(e[v][g], __fmul_rn(x[v][g], ds));
    if (vec) {
      if (nv > 0)
        *reinterpret_cast<float4*>(out + i) =
            make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (g < nv) out[i + g] = o[g];
    }
  }
}

// the two halves of cluster.sync(), split so that work can run between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One chain per cluster of CL = clusterDim.x CTAs; CTA r owns observations
// [r S, min((r + 1) S, n)).  KT: K itself (1 or 4), or 0 for any K <= 32.
template <int FAM, bool GATHER, bool COMMIT, int KT, typename XT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
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
               int n, int K, int S, float param, bool vec,
               Composed comp) {
  constexpr int KB = KT == 0 ? KB_RUNTIME : KT;
  constexpr int V = tile_units<FAM>();
  constexpr int CHUNK = THREADS * V * G;  // observations per CTA per chunk
  __shared__ float s_part[WARPS][KMAX];
  __shared__ float s_cta[KMAX];
  __shared__ float s_dstar;

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int c = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

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
  const int s0 = min(r * S, n);
  const int s1 = min(s0 + S, n);
  const int nchunks = (s1 - s0 + CHUNK - 1) / CHUNK;

  float e[V][G], x[V][G];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int g = 0; g < G; ++g) e[v][g] = x[v][g] = 0.f;

  const int nkb = KT == 0 ? (K + KB - 1) / KB : 1;
  for (int kb = 0; kb < nkb; ++kb) {
    const int nk = KT == 0 ? min(KB, K - kb * KB) : KB;
    float dl[KB], acc[KB];
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      dl[q] = q < nk ? deltas[(size_t)c * K + kb * KB + q] : 0.f;
      acc[q] = 0.f;
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      const int base = s0 + ch * CHUNK;
      if (nchunks > 1 || kb == 0) load_tile(er, xr, base, s1, vec, e, x);
      if constexpr (FAM == FAM_COMPOSED) {
        with_pair(comp, param, [&](auto ld) {
          accumulate<KB>(e, x, y, m, base, s1, vec, dl, nk, ld, acc);
        });
      } else {
        accumulate<KB>(e, x, y, m, base, s1, vec, dl, nk,
                       LdRel<FAM>{param}, acc);
      }
    }
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      if (q >= nk) continue;
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) s_part[warp][kb * KB + q] = v;
    }
  }
  __syncthreads();
  if (tid < K) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, s_part[w][tid]);
    s_cta[tid] = t;
  }
  cluster.sync();

  if (warp == 0) {
    // lane k sums proposal k over the cluster's CTAs in rank order (all
    // CL loads in flight at once); every CTA sums the same floats in the
    // same order, so all decide alike, from exactly what rank 0 stores
    float part[MAX_CLUSTER];
#pragma unroll
    for (int rr = 0; rr < MAX_CLUSTER; ++rr)
      part[rr] = rr < CL && lane < K
                     ? *cluster.map_shared_rank(&s_cta[lane], rr)
                     : 0.f;
    float t = 0.f;
#pragma unroll
    for (int rr = 0; rr < MAX_CLUSTER; ++rr)
      if (rr < CL) t = __fadd_rn(t, part[rr]);
    if (!row_ok) t = __int_as_float(0x7fc00000);  // a bad index poisons
    if (r == 0 && lane < K) lsum[(size_t)c * K + lane] = t;
    if (COMMIT) {
      const float level = scal[(size_t)c * 4 + 0];
      const float ld0 = scal[(size_t)c * 4 + 1];
      const float gate = scal[(size_t)c * 4 + 2];
      const float rem = scal[(size_t)c * 4 + 3];
      bool acc_k = false;
      if (lane < K) {
        const float f =
            __fadd_rn(__fsub_rn(t, ld0), fprior[(size_t)c * K + lane]);
        acc_k = f >= level && (float)lane < rem;
      }
      const unsigned votes = __ballot_sync(0xffffffffu, acc_k);
      if (lane == 0)
        s_dstar = (gate > 0.f && votes != 0u)
                      ? deltas[(size_t)c * K + __ffs(votes) - 1]
                      : 0.f;
    }
  }
  __syncthreads();
  // this CTA has read the others' partials; it may not exit before every
  // CTA of the cluster has read its own, which the wait below ensures, so
  // the commit runs between the arrive and the wait
  cluster_arrive();

  if (COMMIT && nchunks > 0) {
    const float ds = s_dstar;
    float* out = eta_new + (size_t)c * n;
    // the last chunk is still in registers; earlier chunks are read again
    store_tile(out, e, x, ds, s0 + (nchunks - 1) * CHUNK, s1, vec);
    for (int ch = 0; ch + 1 < nchunks; ++ch) {
      const int base = s0 + ch * CHUNK;
      load_tile(er, xr, base, s1, vec, e, x);
      store_tile(out, e, x, ds, base, s1, vec);
    }
  }
  cluster_wait();
}

// The cluster size and slice length for a row of n observations: the
// fewest CTAs whose slices fit one register tile (chunk observations)
// each (fewer, fuller CTAs leave fewer waves), at most MAX_CLUSTER, slices
// a multiple of G long so that every slice starts on a 16-byte boundary of
// an aligned row.
struct Plan {
  int cl, s;
};
inline Plan plan(int n, int chunk) {
  const int cl = min(MAX_CLUSTER, (n + chunk - 1) / chunk);
  const int s = ((n + cl - 1) / cl + G - 1) / G * G;
  return {cl, s};
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int FAM, bool GATHER, bool COMMIT, int KT, typename XT>
cudaError_t launch_kernel(const cudaLaunchConfig_t& cfg, const float* eta,
                          const XT* xsrc, const int32_t* jidx, int d,
                          const float* deltas, const float* fprior,
                          const float* scal, const float* y, const float* m,
                          float* lsum, float* eta_new, int n, int K, int S,
                          float param, bool vec, Composed comp) {
  return cudaLaunchKernelEx(&cfg, battery_kernel<FAM, GATHER, COMMIT, KT, XT>,
                            eta, xsrc, jidx, d, deltas, fprior, scal, y, m,
                            lsum, eta_new, n, K, S, param, vec, comp);
}

template <bool GATHER, bool COMMIT, typename XT = float>
int launch(int fam, const float* eta, const XT* xsrc, const int32_t* jidx,
           int d, const float* deltas, const float* fprior, const float* scal,
           const float* y, const float* m, float* lsum, float* eta_new,
           int C, int n, int K, float param, Composed comp, void* stream) {
  if (C < 1 || n < 1 || K < 1 || K > KMAX ||
      (fam == FAM_COMPOSED && !composed_pair_ok(comp)))
    return (int)cudaErrorInvalidValue;
  const int units = fam == FAM_COMPOSED ? tile_units<FAM_COMPOSED>()
                                        : tile_units<FAM_BINOMIAL_LOGIT>();
  const Plan p = plan(n, THREADS * units * G);
  const bool vec = n % G == 0 && aligned(eta, 16) && aligned(y, 16) &&
                   aligned(m, 16) && aligned(xsrc, G * sizeof(XT)) &&
                   (!COMMIT || aligned(eta_new, 16));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * p.cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaErrorInvalidValue;
#define MCMCGLM_BATTERY_ARGS                                                  \
  cfg, eta, xsrc, jidx, d, deltas, fprior, scal, y, m, lsum, eta_new, n, K,  \
      p.s, param, vec, comp
#define MCMCGLM_BATTERY_CASE(F)                                               \
  case F:                                                                     \
    err = K == 4   ? launch_kernel<F, GATHER, COMMIT, 4, XT>(                 \
                       MCMCGLM_BATTERY_ARGS)                                  \
          : K == 1 ? launch_kernel<F, GATHER, COMMIT, 1, XT>(                 \
                       MCMCGLM_BATTERY_ARGS)                                  \
                   : launch_kernel<F, GATHER, COMMIT, 0, XT>(                 \
                         MCMCGLM_BATTERY_ARGS);                               \
    break;
  switch (fam) {
    MCMCGLM_FOR_EACH_FAMILY(MCMCGLM_BATTERY_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MCMCGLM_BATTERY_CASE
#undef MCMCGLM_BATTERY_ARGS
  if (err != cudaSuccess) return (int)err;
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
                            int fam, float param, int rfam, int rlink,
                            void* stream) {
  return launch<false, false>(fam, eta, xg, nullptr, 0, deltas, nullptr,
                              nullptr, y, m, lsum, nullptr, C, n, K, param,
                              mcmcglm::Composed{rfam, rlink}, stream);
}

// replaces mcmcglm_tpu/ops/freerun_batteries.py::build_battery2
extern "C" int battery_commit(const float* eta, const float* xg,
                              const float* deltas, const float* fprior,
                              const float* scal, const float* y,
                              const float* m, float* lsum, float* eta_new,
                              int C, int n, int K, int fam, float param,
                              int rfam, int rlink, void* stream) {
  return launch<false, true>(fam, eta, xg, nullptr, 0, deltas, fprior, scal,
                             y, m, lsum, eta_new, C, n, K, param,
                             mcmcglm::Composed{rfam, rlink}, stream);
}

// replaces mcmcglm_tpu/ops/freerun_batteries.py::build_battery3
extern "C" int battery_gather_commit(const int32_t* j, const float* Xt, int d,
                                     const float* eta, const float* deltas,
                                     const float* fprior, const float* scal,
                                     const float* y, const float* m,
                                     float* lsum, float* eta_new, int C,
                                     int n, int K, int fam, float param,
                                     int rfam, int rlink, void* stream) {
  return launch<true, true>(fam, eta, Xt, j, d, deltas, fprior, scal, y, m,
                            lsum, eta_new, C, n, K, param,
                            mcmcglm::Composed{rfam, rlink}, stream);
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
                                          int fam, float param, int rfam,
                                          int rlink, void* stream) {
  return launch<true, true, __nv_bfloat16>(fam, eta, Xt, j, d, deltas,
                                           fprior, scal, y, m, lsum, eta_new,
                                           C, n, K, param,
                                           mcmcglm::Composed{rfam, rlink},
                                           stream);
}
