// Fused CGGibbs coordinate updates for Hopper (sm_90a).  Two kernels
// replace the two Pallas kernels of mcmcglm_tpu/ops/pallas_cggibbs.py:
//
//   fused_coord_update <- make_fused_coord_update: one coordinate j of
//                         every chain, one launch per coordinate
//   fused_sweep        <- make_fused_sweep: all d coordinates in order,
//                         one launch per Gibbs sweep
//
// For each chain, a coordinate update is Neal's (2003) stepping-out and
// shrinkage slice update of beta_j on the relative log potential
//
//   g(b) = sum_i [ld(eta_i + x_i (b - b0), y_i) - ld0_i] + (lp(b) - lp0)
//
// with ld0_i = ld(eta_i, y_i) cached at the start of the coordinate, the
// difference taken per observation inside the sum, ld the relative family
// log density of families.cuh (a pair's own path, or the composed route
// with the runtime family and link in Params::comp) and lp the relative
// log density of the IID
// prior (both drop terms that do not depend on their argument, which only
// differences see).  The steps, as the TPU kernels take them:
//
//   level = log(u0);  L = b0 - w u1,  R = L + w;
//   J = floor(u2 max_stepouts),  K = max_stepouts - 1 - J;
//   step L left by w while g(L) > level (strict) and J > 0, then R right
//   while g(R) > level and K > 0, one evaluation per test;
//   shrink: x1 = L + (R - L) u_{3+i}, accept at g(x1) >= level (not
//   strict), else x1 < b0 moves L and x1 >= b0 moves R; after max_shrink
//   rejections the chain keeps b0;
//   eta += x_j (bnew - b0).
//
// The uniforms are Philox4x32-10 (ops/philox.py computes the same): draw t
// of chain c at coordinate j of sweep s has the counter (s, j, c, t) and
// the key (seed_lo, seed_hi), so every draw is chain-local.  The evaluation
// count keeps the TPU kernel's block semantics: per block of bc chains,
// max_c nL + max_c nR + max_c nShrink, given to every chain of the block.
//
// What bounds it on an H100: instructions.  A g evaluation is n log
// densities at a moved predictor, each with its predictor and its cache
// difference: about 38 instructions per observation and evaluation for
// binomial/logit on the fall-through paths of CUDA's accurate expf and
// log1pf (counted in chip_smoke.py), and a coordinate takes nL + nR +
// nShrink such evaluations per chain plus one density per observation for
// the cache.  The bytes a coordinate must move (eta in and out, the X row,
// y) are a few percent of that time at the main shape.
//
// Design: one CTA of THREADS = 512 threads per chain, held to 64 registers
// so that two CTAs share an SM: at C = 256 that is one wave of 256 CTAs
// on the 132 SMs, 32 warps per SM.  Every coordinate runs one device
// function, chain_coord(), which
//
//   1. stages the chain's eta row and the density cache ld0 = ld(eta, y)
//      in shared memory (8n bytes: 80 KB at n = 10,000, so two CTAs fit an
//      SM up to n of about 14,000 and one up to about 29,000), with
//      16-byte loads where the rows are aligned;
//   2. runs the whole slice loop there, every g evaluation a fixed-order
//      block reduction: each thread sums its observations i = t, t + 512,
//      ... in order, a warp butterfly of shuffles follows, the warp
//      partials go to a double-buffered shared slot array, and after one
//      __syncthreads every thread adds them in warp order.  So every
//      thread holds the same bits, the slice loop stays block-uniform, and
//      an evaluation costs one barrier;
//   3. writes eta += x_j (bnew - b0) back to the global row once.
//
// x_j and y come through the read-only path (__ldg): the two CTAs of an
// SM share the row in L1.  Where 8n bytes do not fit a block the same
// function runs on the global rows, eta in place and ld0 in a scratch row,
// with the same arithmetic in the same order; the caller decides by n
// (ON_CHIP_N in ops/fused_cggibbs.py) and passes the scratch, whose
// presence selects the global rows.  fused_sweep is a loop of chain_coord() over j,
// and eta goes back to global memory after every coordinate, so a sweep
// equals d coordinate launches bitwise, by construction.
//
// The block counts: the chains of one block sit in different CTAs, so
// each CTA atomicMax-es its nL, nR and nShrink of coordinate j into a
// zeroed (C / bc, d, 3) int32 scratch, and a second kernel writes every
// chain's nev = sum_j (max nL + max nR + max nShrink).  Integer maxima do
// not depend on the order of the atomics, so the counts are exact.  Every
// float operation that the PyTorch version rounds separately is written
// with __fadd_rn / __fmul_rn, so nvcc cannot contract it into an FMA.
//
// What the layout leaves: eta makes a round trip through global memory at
// every coordinate, 256 x 1,000 x 80 KB (the row in and out) = 20 GB per
// full-width sweep, mostly through the 50 MB L2; and a small C leaves SMs
// idle (one CTA per chain).

#include <cuda_runtime.h>
#include <stdint.h>

#include "families.cuh"

namespace {

using namespace mcmcglm;

constexpr int THREADS = 512;  // one CTA per chain
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BC = 32;  // chains per counting block

// prior ids: keep in step with KERNEL_PRIORS in
// mcmcglm_tpu_torch/ops/fused_cggibbs.py
enum : int {
  PRIOR_NORMAL = 0,       // (loc, scale)
  PRIOR_GAMMA = 1,        // (concentration, rate)
  PRIOR_EXPONENTIAL = 2,  // (rate)
  PRIOR_STUDENT_T = 3,    // (df, loc, scale)
  PRIOR_LAPLACE = 4,      // (loc, scale)
  PRIOR_UNIFORM = 5,      // (low, high)
};

struct Params {
  int n, d, bc;
  uint32_t key0, key1, sweep;
  float w;
  int max_stepouts, max_shrink;
  float fparam;        // the family's scalar extra argument
  float p0, p1, p2;    // the prior's parameters
  Composed comp;       // the composed route's runtime family and link
};

// relative log prior density (b-independent terms dropped); the support
// rules are the JAX package's: -inf for Gamma at b <= 0, Exponential at
// b < 0, Uniform outside [low, high]
template <int PRIOR>
__device__ __forceinline__ float prior_rel(float b, const Params& p) {
  const float ninf = __int_as_float(0xff800000);
  if (PRIOR == PRIOR_NORMAL) {  // -0.5 z^2
    const float z = __fdiv_rn(__fsub_rn(b, p.p0), p.p1);
    return __fmul_rn(__fmul_rn(-0.5f, z), z);
  } else if (PRIOR == PRIOR_GAMMA) {  // (a - 1) log b - r b
    const float bb = fmaxf(b, 1.17549435e-38f);
    const float lp = __fsub_rn(__fmul_rn(__fsub_rn(p.p0, 1.f), logf(bb)),
                               __fmul_rn(p.p1, bb));
    return b > 0.f ? lp : ninf;
  } else if (PRIOR == PRIOR_EXPONENTIAL) {  // -r b
    return b >= 0.f ? __fmul_rn(-p.p0, b) : ninf;
  } else if (PRIOR == PRIOR_STUDENT_T) {  // -(v + 1) / 2 log1p(z^2 / v)
    const float z = __fdiv_rn(__fsub_rn(b, p.p1), p.p2);
    const float t = log1pf(__fdiv_rn(__fmul_rn(z, z), p.p0));
    return __fmul_rn(__fmul_rn(-0.5f, __fadd_rn(p.p0, 1.f)), t);
  } else if (PRIOR == PRIOR_LAPLACE) {  // -|b - loc| / scale
    return -__fdiv_rn(fabsf(__fsub_rn(b, p.p0)), p.p1);
  } else {  // PRIOR_UNIFORM
    return (b >= p.p0 && b <= p.p1) ? 0.f : ninf;
  }
}

// Philox4x32-10 of the counter (c0, c1, c2, c3) under (k0, k1): the first
// output word, mapped to (0, 1) as the TPU kernel's _uniform maps its bits
__device__ __forceinline__ float philox_uniform(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  const float u = __fmul_rn(__uint2float_rn(c0 >> 9), 1.f / 8388608.f);
  return fmaxf(u, 1e-12f);
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The CTA's reduction state: the double-buffered warp partials and the
// buffer the next evaluation writes (block-uniform).
struct Reducer {
  float (*slot)[WARPS];
  int parity;

  // Sum of v over the block in a fixed order; every thread gets the same
  // bits.  One barrier: the buffer written here was last read before the
  // previous evaluation's barrier.
  __device__ __forceinline__ float sum(float v) {
    v = warp_sum(v);
    float* s = slot[parity];
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
    __syncthreads();
    float total = s[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total = __fadd_rn(total, s[w]);
    parity ^= 1;
    return total;
  }
};

struct Counts {
  int left, right, shrink;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The composed route's copies of the two per-observation loops of
// chain_coord below (the six pairs' paths keep them inline): stage the
// working copy and the density cache ld0 = ld(eta, y), and this thread's
// part of g's sum at the moved predictor, with the density functor ld.
template <typename LD>
__device__ __forceinline__ void stage_rows(const float* eta, float* work,
                                           float* ld0,
                                           const float* __restrict__ y,
                                           int n, bool vec, LD ld) {
  const int t0 = threadIdx.x;
  if (vec) {
    for (int q = t0; q < (n >> 2); q += THREADS) {
      const float4 e = reinterpret_cast<const float4*>(eta)[q];
      const float4 v = __ldg(reinterpret_cast<const float4*>(y) + q);
      if (work != eta) reinterpret_cast<float4*>(work)[q] = e;
      float* l = ld0 + 4 * q;
      l[0] = ld(e.x, v.x);
      l[1] = ld(e.y, v.y);
      l[2] = ld(e.z, v.z);
      l[3] = ld(e.w, v.w);
    }
  } else {
    for (int i = t0; i < n; i += THREADS) {
      const float e = eta[i];
      if (work != eta) work[i] = e;
      ld0[i] = ld(e, __ldg(y + i));
    }
  }
}

template <typename LD>
__device__ __forceinline__ float partial_sum(const float* work,
                                             const float* ld0,
                                             const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             int n, float db, LD ld) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float e = __fadd_rn(work[i], __fmul_rn(__ldg(x + i), db));
    acc = __fadd_rn(acc, __fsub_rn(ld(e, __ldg(y + i)), ld0[i]));
  }
  return acc;
}

// One chain's slice update of coordinate j, run by the whole CTA.  eta is
// the chain's global row; work and ld0 are its working copy and density
// cache, in shared memory or (work == eta) in global memory; x is the X
// row.  Returns bnew, identical in every thread.
template <int FAM, int PRIOR>
__device__ float chain_coord(float* eta, float* work, float* ld0,
                             const float* __restrict__ x,
                             const float* __restrict__ y, const Params& p,
                             uint32_t j, uint32_t c, float b0, Reducer& red,
                             Counts& cnt) {
  const int n = p.n;
  const int t0 = threadIdx.x;
  // 16-byte groups where every row is aligned (a layout of its own: the
  // previous coordinate's commit may have used the other one)
  const bool vec = (n & 3) == 0 && aligned16(eta) && aligned16(work) &&
                   aligned16(ld0) && aligned16(x) && aligned16(y);
  __syncthreads();
  if constexpr (FAM == FAM_COMPOSED) {
    with_pair(p.comp, p.fparam, [&](auto ld) {
      stage_rows(eta, work, ld0, y, n, vec, ld);
    });
  } else if (vec) {
    for (int q = t0; q < (n >> 2); q += THREADS) {
      const float4 e = reinterpret_cast<const float4*>(eta)[q];
      const float4 v = __ldg(reinterpret_cast<const float4*>(y) + q);
      if (work != eta) reinterpret_cast<float4*>(work)[q] = e;
      // one density at a time: four live ones spill the gaussian kernels
      float* l = ld0 + 4 * q;
      l[0] = ld_rel<FAM>(e.x, v.x, p.fparam);
      l[1] = ld_rel<FAM>(e.y, v.y, p.fparam);
      l[2] = ld_rel<FAM>(e.z, v.z, p.fparam);
      l[3] = ld_rel<FAM>(e.w, v.w, p.fparam);
    }
  } else {
    for (int i = t0; i < n; i += THREADS) {
      const float e = eta[i];
      if (work != eta) work[i] = e;
      ld0[i] = ld_rel<FAM>(e, __ldg(y + i), p.fparam);
    }
  }
  __syncthreads();  // the evaluations read other threads' staged entries
  const float lp0 = prior_rel<PRIOR>(b0, p);

  auto g = [&](float b) {
    const float db = __fsub_rn(b, b0);
    float acc = 0.f;
    if constexpr (FAM == FAM_COMPOSED) {
      with_pair(p.comp, p.fparam, [&](auto ld) {
        acc = partial_sum(work, ld0, x, y, n, db, ld);
      });
    } else {
      for (int i = t0; i < n; i += THREADS) {
        const float e = __fadd_rn(work[i], __fmul_rn(__ldg(x + i), db));
        acc = __fadd_rn(acc,
                        __fsub_rn(ld_rel<FAM>(e, __ldg(y + i), p.fparam), ld0[i]));
      }
    }
    return __fadd_rn(red.sum(acc), __fsub_rn(prior_rel<PRIOR>(b, p), lp0));
  };
  auto uniform = [&](uint32_t t) {
    return philox_uniform(p.sweep, j, c, t, p.key0, p.key1);
  };

  const float level = logf(uniform(0));
  float L = __fsub_rn(b0, __fmul_rn(p.w, uniform(1)));
  float R = __fadd_rn(L, p.w);
  int budget_l = (int)floorf(__fmul_rn(uniform(2), (float)p.max_stepouts));
  int budget_r = (p.max_stepouts - 1) - budget_l;

  cnt.left = 0;
  for (;;) {
    const float f = g(L);
    ++cnt.left;
    if (!(f > level && budget_l > 0)) break;
    L = __fsub_rn(L, p.w);
    --budget_l;
  }
  cnt.right = 0;
  for (;;) {
    const float f = g(R);
    ++cnt.right;
    if (!(f > level && budget_r > 0)) break;
    R = __fadd_rn(R, p.w);
    --budget_r;
  }

  float bnew = b0;
  cnt.shrink = 0;
  for (int it = 0; it < p.max_shrink; ++it) {
    const float u = uniform(3 + (uint32_t)it);
    const float x1 = __fadd_rn(L, __fmul_rn(__fsub_rn(R, L), u));
    const float f = g(x1);
    ++cnt.shrink;
    if (f >= level) {
      bnew = x1;
      break;
    }
    if (x1 < b0) {
      L = x1;
    } else if (x1 >= b0) {
      R = x1;
    }
  }

  // the commit: each entry is written from its own working copy, and work
  // is only read since the staging barrier, so any layout will do
  const float db = __fsub_rn(bnew, b0);
  if (vec) {
    for (int q = t0; q < (n >> 2); q += THREADS) {
      const float4 e = reinterpret_cast<const float4*>(work)[q];
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + q);
      reinterpret_cast<float4*>(eta)[q] = make_float4(
          __fadd_rn(e.x, __fmul_rn(v.x, db)), __fadd_rn(e.y, __fmul_rn(v.y, db)),
          __fadd_rn(e.z, __fmul_rn(v.z, db)), __fadd_rn(e.w, __fmul_rn(v.w, db)));
    }
  } else {
    for (int i = t0; i < n; i += THREADS)
      eta[i] = __fadd_rn(work[i], __fmul_rn(__ldg(x + i), db));
  }
  return bnew;
}

// Coordinate j of the CTA's chain: the update, beta_j at *bout, and the
// chain's counts into the block maxima at cnt[(block, slot, 0..2)].
template <int FAM, int PRIOR>
__device__ __forceinline__ void block_coord(
    float* eta, float* work, float* ld0, const float* __restrict__ x,
    const float* __restrict__ y, const float* bin, float* bout,
    int32_t* cnt, int slot, const Params& p, int j, Reducer& red) {
  const uint32_t c = blockIdx.x;
  Counts k;
  const float bnew = chain_coord<FAM, PRIOR>(eta, work, ld0, x, y, p,
                                             (uint32_t)j, c, *bin, red, k);
  if (threadIdx.x == 0) {
    *bout = bnew;
    int32_t* m = cnt + ((size_t)(c / p.bc) * p.d + slot) * 3;
    atomicMax(m, k.left);
    atomicMax(m + 1, k.right);
    atomicMax(m + 2, k.shrink);
  }
}

// The chain's rows: eta and ld0 in dynamic shared memory when there is no
// global scratch, else eta in place and ld0 in the scratch.
struct Rows {
  float *eta, *work, *ld0;
};

__device__ __forceinline__ Rows chain_rows(float* eta, float* ld0g, int n) {
  extern __shared__ float4 s_dyn[];  // 16-byte aligned
  float* s = reinterpret_cast<float*>(s_dyn);
  const size_t row = (size_t)blockIdx.x * n;
  if (ld0g == nullptr) return Rows{eta + row, s, s + n};
  return Rows{eta + row, eta + row, ld0g + row};
}

template <int FAM, int PRIOR>
__global__ void __launch_bounds__(THREADS, 2)
fused_coord_kernel(float* eta, float* ld0g, const float* bj_in,
                   float* bj_out, int32_t* cnt, const float* __restrict__ xj,
                   const float* __restrict__ y, Params p, int j) {
  __shared__ float s_slot[2][WARPS];
  Reducer red{s_slot, 0};
  const Rows r = chain_rows(eta, ld0g, p.n);
  block_coord<FAM, PRIOR>(r.eta, r.work, r.ld0, xj, y, bj_in + blockIdx.x,
                          bj_out + blockIdx.x, cnt, 0, p, j, red);
}

template <int FAM, int PRIOR>
__global__ void __launch_bounds__(THREADS, 2)
fused_sweep_kernel(float* eta, float* ld0g, float* beta, int32_t* cnt,
                   const float* __restrict__ Xt, const float* __restrict__ y,
                   Params p) {
  __shared__ float s_slot[2][WARPS];
  Reducer red{s_slot, 0};
  const Rows r = chain_rows(eta, ld0g, p.n);
  float* b = beta + (size_t)blockIdx.x * p.d;
  for (int j = 0; j < p.d; ++j)
    block_coord<FAM, PRIOR>(r.eta, r.work, r.ld0, Xt + (size_t)j * p.n, y,
                            b + j, b + j, cnt, j, p, j, red);
}

// nev[c] = sum over the d slots of chain c's block of max nL + max nR +
// max nShrink
__global__ void block_counts_kernel(const int32_t* __restrict__ cnt,
                                    int32_t* nev, int C, int bc, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int32_t* m = cnt + (size_t)(c / bc) * d * 3;
  int total = 0;
  for (int k = 0; k < 3 * d; ++k) total += m[k];
  nev[c] = total;
}

// The update kernel, then the counts.  The shared rows take 8n bytes; the
// opt-in above 48 KB is set at every launch, since the attribute belongs to
// the current device's context (a host call, allowed during graph capture),
// and fails for rows beyond the block's limit.
template <auto kernel, typename... Args>
int launch_kernel(int C, const Params& p, const float* ld0g, int32_t* cnt,
                  int32_t* nev, cudaStream_t s, Args... args) {
  const int smem = ld0g == nullptr ? 8 * p.n : 0;
  const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  kernel<<<C, THREADS, smem, s>>>(args...);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  block_counts_kernel<<<(C + 255) / 256, 256, 0, s>>>(cnt, nev, C, p.bc,
                                                      p.d);
  return (int)cudaGetLastError();
}

bool bad_shape(int C, int fam, const Params& p) {
  return C < 1 || p.n < 1 || p.d < 1 || p.bc < 1 || p.bc > MAX_BC ||
         C % p.bc != 0 || p.max_stepouts < 0 || p.max_shrink < 0 ||
         (fam == FAM_COMPOSED && !composed_pair_ok(p.comp));
}

Params make_params(int n, int d, int bc, uint32_t key0, uint32_t key1,
                   uint32_t sweep, float w, int max_stepouts, int max_shrink,
                   float fparam, int rfam, int rlink, float p0, float p1,
                   float p2) {
  Params p;
  p.n = n;
  p.d = d;
  p.bc = bc;
  p.key0 = key0;
  p.key1 = key1;
  p.sweep = sweep;
  p.w = w;
  p.max_stepouts = max_stepouts;
  p.max_shrink = max_shrink;
  p.fparam = fparam;
  p.p0 = p0;
  p.p1 = p1;
  p.p2 = p2;
  p.comp = Composed{rfam, rlink};
  return p;
}

#define MCMCGLM_FOR_EACH_PRIOR(X, F) \
  X(F, PRIOR_NORMAL)                 \
  X(F, PRIOR_GAMMA)                  \
  X(F, PRIOR_EXPONENTIAL)            \
  X(F, PRIOR_STUDENT_T)              \
  X(F, PRIOR_LAPLACE)                \
  X(F, PRIOR_UNIFORM)

// key of the (family, prior) pair in one switch: fam * 8 + prior
#define MCMCGLM_PAIR_KEY(F, P) ((F) * 8 + (P))

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each returns a CUDA
// error code (0 on success): cudaErrorInvalidValue for operands outside
// the kernel's limits, else cudaGetLastError() after the launches.
// Pointers are device pointers to contiguous float32 (int32 for nev and
// cnt) tensors; eta (C, n) and beta are updated in place; ld0 is a (C, n)
// scratch that selects the global rows, or null for the shared rows (an
// error where 8n bytes exceed a block's shared memory); cnt is the
// zeroed (C / bc, d, 3) scratch of the block maxima (d = 1 for a
// coordinate).  Two launches (the update, then the counts) go on the
// given stream, which is not synchronised.

// replaces mcmcglm_tpu/ops/pallas_cggibbs.py::make_fused_coord_update
extern "C" int fused_coord_update(float* eta, float* ld0, const float* bj_in,
                                  float* bj_out, int32_t* cnt, int32_t* nev,
                                  const float* xj, const float* y, int C,
                                  int n, int bc, int j, uint32_t key0,
                                  uint32_t key1, uint32_t sweep, float w,
                                  int max_stepouts, int max_shrink, int fam,
                                  float fparam, int rfam, int rlink,
                                  int prior, float p0, float p1, float p2,
                                  void* stream) {
  const Params p = make_params(n, 1, bc, key0, key1, sweep, w, max_stepouts,
                               max_shrink, fparam, rfam, rlink, p0, p1, p2);
  if (bad_shape(C, fam, p) || j < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCMCGLM_COORD_CASE(F, P)                                           \
  case MCMCGLM_PAIR_KEY(F, P):                                             \
    return launch_kernel<fused_coord_kernel<F, P>>(                       \
        C, p, ld0, cnt, nev, s, eta, ld0, bj_in, bj_out, cnt, xj, y, p, j);
#define MCMCGLM_COORD_FAMILY(F) MCMCGLM_FOR_EACH_PRIOR(MCMCGLM_COORD_CASE, F)
  switch (MCMCGLM_PAIR_KEY(fam, prior)) {
    MCMCGLM_FOR_EACH_FAMILY(MCMCGLM_COORD_FAMILY)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MCMCGLM_COORD_FAMILY
#undef MCMCGLM_COORD_CASE
}

// replaces mcmcglm_tpu/ops/pallas_cggibbs.py::make_fused_sweep
extern "C" int fused_sweep(float* eta, float* ld0, float* beta, int32_t* cnt,
                           int32_t* nev, const float* Xt, const float* y,
                           int C, int n, int d, int bc, uint32_t key0,
                           uint32_t key1, uint32_t sweep, float w,
                           int max_stepouts, int max_shrink, int fam,
                           float fparam, int rfam, int rlink, int prior,
                           float p0, float p1, float p2, void* stream) {
  const Params p = make_params(n, d, bc, key0, key1, sweep, w, max_stepouts,
                               max_shrink, fparam, rfam, rlink, p0, p1, p2);
  if (bad_shape(C, fam, p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCMCGLM_SWEEP_CASE(F, P)                                            \
  case MCMCGLM_PAIR_KEY(F, P):                                              \
    return launch_kernel<fused_sweep_kernel<F, P>>(                        \
        C, p, ld0, cnt, nev, s, eta, ld0, beta, cnt, Xt, y, p);
#define MCMCGLM_SWEEP_FAMILY(F) MCMCGLM_FOR_EACH_PRIOR(MCMCGLM_SWEEP_CASE, F)
  switch (MCMCGLM_PAIR_KEY(fam, prior)) {
    MCMCGLM_FOR_EACH_FAMILY(MCMCGLM_SWEEP_FAMILY)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MCMCGLM_SWEEP_FAMILY
#undef MCMCGLM_SWEEP_CASE
}
