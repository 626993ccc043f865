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
// log density of families.cuh and lp the relative log density of the IID
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
// Design: one CTA per chain block, one warp per chain.  The warp's lanes
// stride over the n observations; a g evaluation is a per-lane partial sum
// and a butterfly of warp shuffles, in a fixed order, which leaves the same
// bits in every lane, so the whole slice loop runs warp-uniform with no
// block synchronisation, and each chain takes only the evaluations it
// needs.  eta and the ld0 cache live in global memory (at C = 256,
// n = 10,000 they are 20 MB together, which stays in the 50 MB L2); the X
// row is staged once per coordinate in shared memory (n floats, 40 KB at
// n = 10,000), which bounds n at MAX_FUSED_N = 58,016.  Every float
// operation that the PyTorch version rounds separately is written with
// __fadd_rn / __fmul_rn, so nvcc cannot contract it into an FMA.
//
// fused_sweep runs the same block_coord() as fused_coord_update, once per
// j, and ld0 is recomputed from eta at the start of every coordinate in
// both, so a sweep equals d coordinate launches bitwise.
//
// What bounds it on an H100: each g evaluation is n log densities (an
// expf and a log1pf each for binomial/logit) and two L2 reads per
// observation; a coordinate takes about nL + nR + nShrink + 2 such passes
// over n per chain.  The known bound of this simple design is occupancy:
// C / bc CTAs of bc warps, 32 CTAs of 8 warps at C = 256 on 132 SMs, so
// most SMs idle and each SM has too few warps to hide latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "families.cuh"

namespace {

using namespace mcmcglm;

constexpr int MAX_BC = 32;  // chains per block: one warp each

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

struct Counts {
  int left, right, shrink;
};

// One chain's slice update of coordinate j, run by one warp.  eta and ld0
// are the chain's rows; xs is the X row in shared memory.
template <int FAM, int PRIOR>
__device__ float chain_update(float* __restrict__ eta,
                              float* __restrict__ ld0,
                              const float* __restrict__ xs,
                              const float* __restrict__ y, const Params& p,
                              uint32_t j, uint32_t c, float b0, Counts& cnt) {
  const int lane = threadIdx.x & 31;
  const int n = p.n;
  for (int i = lane; i < n; i += 32)
    ld0[i] = ld_rel<FAM>(eta[i], y[i], p.fparam);
  const float lp0 = prior_rel<PRIOR>(b0, p);

  auto g = [&](float b) {
    const float db = __fsub_rn(b, b0);
    float acc = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = __fadd_rn(eta[i], __fmul_rn(xs[i], db));
      acc = __fadd_rn(acc, __fsub_rn(ld_rel<FAM>(e, y[i], p.fparam), ld0[i]));
    }
    return __fadd_rn(warp_sum(acc), __fsub_rn(prior_rel<PRIOR>(b, p), lp0));
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

  const float db = __fsub_rn(bnew, b0);
  for (int i = lane; i < n; i += 32)
    eta[i] = __fadd_rn(eta[i], __fmul_rn(xs[i], db));
  return bnew;
}

// Coordinate j of the CTA's chain block: stage the X row, update every
// chain (one warp each), return the block's evaluation count.  beta of
// chain c is read at bin[c * bstride] and written at bout[c * bstride].
template <int FAM, int PRIOR>
__device__ int block_coord(float* eta, float* ld0,
                           const float* __restrict__ xrow,
                           const float* __restrict__ y, const float* bin,
                           float* bout, int bstride, const Params& p,
                           int j) {
  extern __shared__ float s_x[];
  __shared__ int s_cnt[3][MAX_BC];
  // the previous coordinate is done with s_x and s_cnt
  __syncthreads();
  for (int i = threadIdx.x; i < p.n; i += blockDim.x) s_x[i] = xrow[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * p.bc + warp;
  const size_t row = (size_t)c * p.n;
  Counts cnt;
  const float bnew = chain_update<FAM, PRIOR>(
      eta + row, ld0 + row, s_x, y, p, (uint32_t)j, (uint32_t)c,
      bin[(size_t)c * bstride], cnt);
  if ((threadIdx.x & 31) == 0) {
    bout[(size_t)c * bstride] = bnew;
    s_cnt[0][warp] = cnt.left;
    s_cnt[1][warp] = cnt.right;
    s_cnt[2][warp] = cnt.shrink;
  }
  __syncthreads();
  int ml = 0, mr = 0, ms = 0;
  for (int w = 0; w < p.bc; ++w) {
    ml = max(ml, s_cnt[0][w]);
    mr = max(mr, s_cnt[1][w]);
    ms = max(ms, s_cnt[2][w]);
  }
  return ml + mr + ms;
}

template <int FAM, int PRIOR>
__global__ void __launch_bounds__(MAX_BC * 32)
fused_coord_kernel(float* eta, float* ld0, const float* bj_in, float* bj_out,
                   int32_t* nev, const float* __restrict__ xj,
                   const float* __restrict__ y, Params p, int j) {
  const int total =
      block_coord<FAM, PRIOR>(eta, ld0, xj, y, bj_in, bj_out, 1, p, j);
  if ((threadIdx.x & 31) == 0)
    nev[blockIdx.x * p.bc + (threadIdx.x >> 5)] = total;
}

template <int FAM, int PRIOR>
__global__ void __launch_bounds__(MAX_BC * 32)
fused_sweep_kernel(float* eta, float* ld0, float* beta, int32_t* nev,
                   const float* __restrict__ Xt, const float* __restrict__ y,
                   Params p) {
  int total = 0;
  for (int j = 0; j < p.d; ++j)
    total += block_coord<FAM, PRIOR>(eta, ld0, Xt + (size_t)j * p.n, y,
                                     beta + j, beta + j, p.d, p, j);
  if ((threadIdx.x & 31) == 0)
    nev[blockIdx.x * p.bc + (threadIdx.x >> 5)] = total;
}

constexpr int STATIC_SMEM = 3 * MAX_BC * 4;
constexpr int MAX_SMEM = 232448;  // a block's limit on sm_90

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, int C, const Params& p, cudaStream_t s,
                  Args... args) {
  const int smem = p.n * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<C / p.bc, p.bc * 32, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_shape(int C, const Params& p) {
  return C < 1 || p.n < 1 || p.d < 1 || p.bc < 1 || p.bc > MAX_BC ||
         C % p.bc != 0 || p.n * 4 + STATIC_SMEM > MAX_SMEM ||
         p.max_stepouts < 0 || p.max_shrink < 0;
}

Params make_params(int n, int d, int bc, uint32_t key0, uint32_t key1,
                   uint32_t sweep, float w, int max_stepouts, int max_shrink,
                   float fparam, float p0, float p1, float p2) {
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
// the kernel's limits, else cudaGetLastError() after the launch.  Pointers
// are device pointers to contiguous float32 (int32 for nev) tensors; eta
// (C, n) and beta are updated in place, ld0 (C, n) is scratch; the launch
// goes on the given stream and does not synchronise.

// replaces mcmcglm_tpu/ops/pallas_cggibbs.py::make_fused_coord_update
extern "C" int fused_coord_update(float* eta, float* ld0, const float* bj_in,
                                  float* bj_out, int32_t* nev,
                                  const float* xj, const float* y, int C,
                                  int n, int bc, int j, uint32_t key0,
                                  uint32_t key1, uint32_t sweep, float w,
                                  int max_stepouts, int max_shrink, int fam,
                                  float fparam, int prior, float p0, float p1,
                                  float p2, void* stream) {
  const Params p = make_params(n, 1, bc, key0, key1, sweep, w, max_stepouts,
                               max_shrink, fparam, p0, p1, p2);
  if (bad_shape(C, p) || j < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCMCGLM_COORD_CASE(F, P)                                           \
  case MCMCGLM_PAIR_KEY(F, P):                                             \
    return launch_kernel(fused_coord_kernel<F, P>, C, p, s, eta, ld0,      \
                         bj_in, bj_out, nev, xj, y, p, j);
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
extern "C" int fused_sweep(float* eta, float* ld0, float* beta, int32_t* nev,
                           const float* Xt, const float* y, int C, int n,
                           int d, int bc, uint32_t key0, uint32_t key1,
                           uint32_t sweep, float w, int max_stepouts,
                           int max_shrink, int fam, float fparam, int prior,
                           float p0, float p1, float p2, void* stream) {
  const Params p = make_params(n, d, bc, key0, key1, sweep, w, max_stepouts,
                               max_shrink, fparam, p0, p1, p2);
  if (bad_shape(C, p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCMCGLM_SWEEP_CASE(F, P)                                           \
  case MCMCGLM_PAIR_KEY(F, P):                                             \
    return launch_kernel(fused_sweep_kernel<F, P>, C, p, s, eta, ld0, beta, \
                         nev, Xt, y, p);
#define MCMCGLM_SWEEP_FAMILY(F) MCMCGLM_FOR_EACH_PRIOR(MCMCGLM_SWEEP_CASE, F)
  switch (MCMCGLM_PAIR_KEY(fam, prior)) {
    MCMCGLM_FOR_EACH_FAMILY(MCMCGLM_SWEEP_FAMILY)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MCMCGLM_SWEEP_FAMILY
#undef MCMCGLM_SWEEP_CASE
}
