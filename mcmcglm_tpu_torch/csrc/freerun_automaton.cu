// The free-running pass's per-chain automaton on Hopper (sm_90a): two
// kernels, one thread per chain, on either side of the battery
// (freerun_battery.cu, battery_gather_commit or battery_commit):
//
//   pass_propose   the pass's Philox uniforms, the pseudo-target gather,
//                  the K bracket-space proposals (the shrink recursion
//                  toward the pivot, or the stepping endpoints L - k w /
//                  R + k w), their x-space images, and the battery's
//                  operands: deltas, fprior and scal = [level, ld0, gate,
//                  rem]
//   pass_advance   the battery's sums consumed: the stepping-out moves and
//                  the first acceptor, the commit of beta[c, j] and of the
//                  density cache, the warmup's Robbins-Monro pulls, the
//                  evaluation count, the coordinate and sweep bookkeeping
//                  (a finished sweep's draws slot), the next coordinate's
//                  begin, and the pass index and budget
//
// They replace no TPU kernel: the JAX package leaves this scalar work to
// XLA, which fuses it around its Pallas battery.  The plain version they
// are held against is the PyTorch pass, ops/freerun_passes.py::
// run_pass_spec with _finish and FreeRunCGGibbs._begin_coord, for the
// stepping_out and quantile slice kernels and the IID priors of
// KERNEL_PRIORS.  That pass is about 250 small PyTorch operations, each a
// launch of ~1.1-1.4 us on an H100 that does a few hundred chains' worth of
// scalar work; here the same work is two launches.
//
// What bounds them: latency.  A chain's work is a few thousand dependent
// instructions (10 Philox rounds per uniform, tanf or ndtri per proposal,
// the prior and pseudo-density logs) on registers, and it reads and writes
// only the chain's registers, a (C, K) row of each workspace array, and
// one element of its (C, d) rows.  THREADS = 32, one warp per CTA, so that
// up to 132 x 32 chains each have an SM's scheduler to themselves.
//
// Arithmetic: float32 throughout, no fast-math intrinsics, and every
// product and sum that the PyTorch pass rounds separately is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so that nvcc cannot
// contract it into an FMA; the transcendental functions are CUDA's
// accurate ones that PyTorch's CUDA kernels call (logf, expf, log1pf,
// tanf, atanf, erff, lgammaf), and ndtri is PyTorch's own CUDA version
// (ATen/native/cuda/Math.cuh).  A division by a host number is a product
// with its reciprocal, as PyTorch's CUDA division by a Python scalar
// computes it.  f = (lsum - ld0) + fprior is rounded as the battery's
// in-kernel replay rounds it, so the first acceptor here is the one whose
// move the battery committed to eta.
//
// The pass index: pass_propose marks a lane active when its sweep count is
// below the quota and the pass budget is positive, and ORs "some lane is
// active" into a flag word (one atomic per warp); the first thread of
// pass_advance adds the flag to the pass index, takes it from the budget
// and clears the flag.  No other thread of pass_advance reads the index or
// the budget, and pass_advance reads each lane's activity from
// pass_propose's record, so nothing races.  Registers, beta, logw and qloc
// are updated in place: the caller hands in buffers it owns.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "philox.cuh"
#include "priors.cuh"

namespace {

using namespace mcmcglm;

constexpr int THREADS = 32;  // one warp per CTA
constexpr int KMAX = 32;
constexpr int N_BEGIN = 3;  // uniforms of a coordinate begin

enum : int { SLICE_STEPPING_OUT = 0, SLICE_QUANTILE = 1 };
// a lane's coordinate begin: 0 the full stepping-out schedule, 1 shrink
// only, 2 per lane (two-phase warmup: shrink only once its sweep count
// reaches the stepping-out quota)
enum : int { BEGIN_STEP = 0, BEGIN_SHRINK = 1, BEGIN_PER_LANE = 2 };

// keep in step with _INTS and _FLOATS in ops/freerun_automaton.py
struct Params {
  int C, d, K, S;  // chains, coordinates, proposals, draws slots (0: none)
  int slice, q_adapt, q_normal, prior;
  int max_shrink, max_stepouts, adapt, begin;
  float q_loc, q_scale;  // the fixed pseudo-target
  float q_norm;          // float32(log q_scale + log(2 pi) / 2)
  float q_pi_scale;      // float32(pi q_scale)
  float p0, p1, p2;      // the prior's parameters
  float pc;              // float32(log(2 pi) / 2) (Normal), high - low (Uniform)
  float rate, keep_rate;  // the Robbins-Monro rate r and float32(1 - r)
  float adapt_c, q_c, half_log_2pi;
};
constexpr int N_INTS = 12;
constexpr int N_FLOATS = 13;
static_assert(offsetof(Params, q_loc) == N_INTS * sizeof(int), "layout");
static_assert(sizeof(Params) == (N_INTS + N_FLOATS) * 4, "layout");

// device pointers; keep in step with _PTRS in ops/freerun_automaton.py.
// Registers are (C,); beta, logw and qloc (C, d); draws (C, S, d) and
// nevbuf (C, S); the workspace deltas, fprior, xs, Ls, Rs and lsum (C, K),
// scal (C, 4), u (C, K + 3), act (C,); the scalars are 0-d int64.
struct Ptrs {
  int32_t *j, *phase, *stepdir, *budL, *budR, *n_shrink, *nev, *sc;
  float *level, *L, *R, *b0, *lp0, *w, *xprop, *ld0;
  float *beta, *logw, *qloc, *draws;
  int32_t* nevbuf;
  const long long *key, *quota, *stepout;
  long long *ctr, *budget;
  float *deltas, *fprior, *scal, *xs, *Ls, *Rs, *u;
  int32_t *act, *flag;
  const float* lsum;
};
constexpr int N_PTRS = 36;
static_assert(sizeof(Ptrs) == N_PTRS * sizeof(void*), "layout");

constexpr float PI_F = 3.14159265358979323846f;
constexpr float SQRT1_2_F = 0.70710678118654752440f;
constexpr float U_LO = (float)1e-7;  // the pseudo-target's clip
constexpr float U_HI = (float)(1.0 - 1e-7);
constexpr float ADAPT_EPS = (float)1e-6;

// torch.clamp: NaN propagates
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// PyTorch's CUDA ndtri (ATen/native/cuda/Math.cuh, Cephes), written as it
// is there, FMA contraction left to the compiler as there
__device__ __forceinline__ float polevl(float x, const float* A, int len) {
  float result = 0;
  for (int i = 0; i < len; ++i) result = result * x + A[i];
  return result;
}

__device__ float ndtri(float y0) {
  constexpr float zero = 0;
  constexpr float one = 1;
  if (y0 == zero) return ninf();
  if (y0 == one) return __int_as_float(0x7f800000);
  if (y0 < zero || y0 > one) return __int_as_float(0x7fc00000);
  bool code = true;
  float y = y0;
  if (y > one - float{0.13533528323661269189}) {
    y = one - y;
    code = false;
  }
  if (y > float{0.13533528323661269189}) {
    const float P0[5] = {
        -5.99633501014107895267E1, 9.80010754185999661536E1,
        -5.66762857469070293439E1, 1.39312609387279679503E1,
        -1.23916583867381258016E0,
    };
    const float Q0[9] = {
        1.00000000000000000000E0,  1.95448858338141759834E0,
        4.67627912898881538453E0,  8.63602421390890590575E1,
        -2.25462687854119370527E2, 2.00260212380060660359E2,
        -8.20372256168333339912E1, 1.59056225126211695515E1,
        -1.18331621121330003142E0,
    };
    constexpr float s2pi = 2.50662827463100050242E0;
    y = y - float{0.5};
    const float y2 = y * y;
    const float x = y + y * (y2 * polevl(y2, P0, 5) / polevl(y2, Q0, 9));
    return x * s2pi;
  }
  float x = sqrtf(float{-2.} * logf(y));
  const float x0 = x - (logf(x) / x);
  const float z = one / x;
  float x1;
  if (x < float{8.0}) {
    const float P1[9] = {
        4.05544892305962419923E0,  3.15251094599893866154E1,
        5.71628192246421288162E1,  4.40805073893200834700E1,
        1.46849561928858024014E1,  2.18663306850790267539E0,
        -1.40256079171354495875E-1, -3.50424626827848203418E-2,
        -8.57456785154685413611E-4,
    };
    const float Q1[9] = {
        1.00000000000000000000E0,  1.57799883256466749731E1,
        4.53907635128879210584E1,  4.13172038254672030440E1,
        1.50425385692907503408E1,  2.50464946208309415979E0,
        -1.42182922854787788574E-1, -3.80806407691578277194E-2,
        -9.33259480895457427372E-4,
    };
    x1 = z * polevl(z, P1, 9) / polevl(z, Q1, 9);
  } else {
    const float P2[9] = {
        3.23774891776946035970E0,  6.91522889068984211695E0,
        3.93881025292474443415E0,  1.33303460815807542389E0,
        2.01485389549179081538E-1, 1.23716634817820021358E-2,
        3.01581553508235416007E-4, 2.65806974686737550832E-6,
        6.23974539184983293730E-9,
    };
    const float Q2[9] = {
        1.00000000000000000000E0,  6.02427039364742014255E0,
        3.67983563856160859403E0,  1.37702099489081330271E0,
        2.16236993594496635890E-1, 1.34204006088543189037E-2,
        3.28014464682127739104E-4, 2.89247864745380683936E-6,
        6.79019408009981274425E-9,
    };
    x1 = z * polevl(z, P2, 9) / polevl(z, Q2, 9);
  }
  x = x0 - x1;
  return (!code) ? x : -x;
}

// the prior's full log density (models/priors.py, its constants included),
// as PyTorch evaluates it on 0-d device tensors
__device__ float prior_lp(float x, const Params& p) {
  switch (p.prior) {
    case PRIOR_NORMAL: {
      const float z = __fdiv_rn(__fsub_rn(x, p.p0), p.p1);
      const float q = __fmul_rn(__fmul_rn(z, -0.5f), z);
      return __fsub_rn(__fsub_rn(q, logf(p.p1)), p.pc);
    }
    case PRIOR_GAMMA: {  // (concentration, rate)
      const float xin = isnan(x) ? x : fmaxf(x, 1.17549435e-38f);
      const float a = __fsub_rn(__fmul_rn(p.p0, logf(p.p1)), lgammaf(p.p0));
      const float b = __fmul_rn(__fsub_rn(p.p0, 1.f), logf(xin));
      const float lp = __fsub_rn(__fadd_rn(a, b), __fmul_rn(p.p1, xin));
      return x > 0.f ? lp : ninf();
    }
    case PRIOR_EXPONENTIAL:
      return x >= 0.f ? __fsub_rn(logf(p.p0), __fmul_rn(p.p0, x)) : ninf();
    case PRIOR_STUDENT_T: {  // (df, loc, scale)
      const float v = p.p0;
      const float z = __fdiv_rn(__fsub_rn(x, p.p1), p.p2);
      const float hv1 = __fmul_rn(__fadd_rn(v, 1.f), 0.5f);
      float t = __fsub_rn(lgammaf(hv1), lgammaf(__fmul_rn(v, 0.5f)));
      t = __fsub_rn(t, __fmul_rn(0.5f, logf(__fmul_rn(v, PI_F))));
      t = __fsub_rn(t, logf(p.p2));
      const float r = log1pf(__fdiv_rn(__fmul_rn(z, z), v));
      return __fsub_rn(t, __fmul_rn(hv1, r));
    }
    case PRIOR_LAPLACE: {
      const float t = __fdiv_rn(-fabsf(__fsub_rn(x, p.p0)), p.p1);
      return __fsub_rn(t, logf(__fmul_rn(2.f, p.p1)));
    }
    default:  // PRIOR_UNIFORM (low, high); pc = high - low
      return (x >= p.p0 && x <= p.p1) ? -logf(p.pc) : ninf();
  }
}

// The quantile kernel's pseudo-target (FreeRunCGGibbs.quantile_ppf,
// quantile_cdf, quantile_logpdf).  ``fixed``: the engine's own loc and
// scale, Python numbers there, so a division by the scale is a product
// with its float32 reciprocal; else the lane's adapted (loc, scale).
struct Pseudo {
  float loc, scale;
  bool fixed;
};

__device__ __forceinline__ float pseudo_z(float x, const Pseudo& q) {
  const float dx = __fsub_rn(x, q.loc);
  return q.fixed ? __fmul_rn(dx, __fdiv_rn(1.f, q.scale))
                 : __fdiv_rn(dx, q.scale);
}

__device__ float pseudo_ppf(float u, const Pseudo& q, const Params& p) {
  u = clamp_t(u, U_LO, U_HI);
  const float t = p.q_normal ? ndtri(u)
                             : tanf(__fmul_rn(__fsub_rn(u, 0.5f), PI_F));
  return __fadd_rn(__fmul_rn(t, q.scale), q.loc);
}

__device__ float pseudo_cdf(float x, const Pseudo& q, const Params& p) {
  const float z = pseudo_z(x, q);
  if (p.q_normal)  // torch.special.ndtr: (1 + erf(z / sqrt 2)) / 2
    return __fmul_rn(__fadd_rn(erff(__fmul_rn(z, SQRT1_2_F)), 1.f), 0.5f);
  return __fadd_rn(__fmul_rn(atanf(z), __fdiv_rn(1.f, PI_F)), 0.5f);
}

__device__ float pseudo_logpdf(float x, const Pseudo& q, const Params& p) {
  const float z = pseudo_z(x, q);
  if (p.q_normal) {
    const float t = __fmul_rn(__fmul_rn(z, -0.5f), z);
    return q.fixed ? __fsub_rn(t, p.q_norm)
                   : __fsub_rn(__fsub_rn(t, logf(q.scale)), p.half_log_2pi);
  }
  const float ps = q.fixed ? p.q_pi_scale : __fmul_rn(q.scale, PI_F);
  return -logf(__fmul_rn(ps, __fadd_rn(__fmul_rn(z, z), 1.f)));
}

// the lane's pseudo-target at coordinate j
__device__ __forceinline__ Pseudo pseudo_at(const Ptrs& q, const Params& p,
                                            size_t row) {
  if (p.q_adapt) return {q.qloc[row], expf(q.logw[row]), false};
  return {p.q_loc, p.q_scale, true};
}

__global__ void __launch_bounds__(THREADS)
    pass_propose_kernel(Ptrs q, Params p) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  bool active = false;
  if (c < p.C) {
    const int K = p.K, W = K + N_BEGIN;
    active = *q.budget > 0 && (long long)q.sc[c] < *q.quota;
    q.act[c] = active;
    const long long pidx = *q.ctr;
    const uint32_t p_lo = (uint32_t)pidx, p_hi = (uint32_t)(pidx >> 32);
    const uint32_t k0 = (uint32_t)q.key[0], k1 = (uint32_t)q.key[1];
    float* u = q.u + (size_t)c * W;

    const int jj = q.j[c], ph = q.phase[c], sd = q.stepdir[c];
    const float L = q.L[c], R = q.R[c], w = q.w[c], b0 = q.b0[c];
    const float lp0 = q.lp0[c];
    const bool quant = p.slice == SLICE_QUANTILE;
    // the shrink pivot: u0 = F(b0) (the w register) for quantile, else b0
    const float piv = quant ? w : b0;
    Pseudo ps{};
    float lpsi0 = 0.f;
    if (quant) {
      ps = pseudo_at(q, p, (size_t)c * p.d + jj);
      lpsi0 = pseudo_logpdf(b0, ps, p);
    }
    float Lc = L, Rc = R;
    const size_t row = (size_t)c * K;
    for (int k = 0; k < K; ++k) {
      const float uk = philox_uniform(p_lo, p_hi, (uint32_t)c, (uint32_t)k,
                                      k0, k1);
      u[k] = uk;
      // the all-rejections shrink chain: proposal k on the bracket left by
      // rejecting proposals 0 .. k - 1
      const float x_sh = __fadd_rn(Lc, __fmul_rn(__fsub_rn(Rc, Lc), uk));
      if (x_sh < piv) Lc = x_sh;
      if (x_sh >= piv) Rc = x_sh;
      q.Ls[row + k] = Lc;
      q.Rs[row + k] = Rc;
      const float kw = __fmul_rn((float)k, w);
      const float x_st = sd == 0 ? __fsub_rn(L, kw) : __fadd_rn(R, kw);
      const float x = ph == 0 ? x_st : x_sh;
      const float xe = quant ? pseudo_ppf(x, ps, p) : x;
      q.xs[row + k] = xe;
      q.deltas[row + k] = __fsub_rn(xe, b0);
      float fp = __fsub_rn(prior_lp(xe, p), lp0);
      if (quant)  // the transformed target h = f - log psi
        fp = __fadd_rn(fp, __fsub_rn(lpsi0, pseudo_logpdf(xe, ps, p)));
      q.fprior[row + k] = fp;
    }
    for (int t = K; t < W; ++t)
      u[t] = philox_uniform(p_lo, p_hi, (uint32_t)c, (uint32_t)t, k0, k1);
    const int rem = max(p.max_shrink - q.n_shrink[c], 0);
    float* scal = q.scal + (size_t)c * 4;
    scal[0] = q.level[c];
    scal[1] = q.ld0[c];
    scal[2] = (ph == 1 && active) ? 1.f : 0.f;
    scal[3] = (float)rem;
  }
  if (__ballot_sync(0xffffffffu, active) != 0u && threadIdx.x == 0)
    atomicOr(q.flag, 1);
}

// The registers of a lane's next coordinate jn (FreeRunCGGibbs.
// _begin_coord and _begin_coord_quantile), from the begin uniforms ub.
__device__ void begin_coord(const Ptrs& q, const Params& p, int c, int jn,
                            bool shrink_only, const float* ub) {
  const size_t row = (size_t)c * p.d + jn;
  const float b0 = q.beta[row];
  q.level[c] = log1pf(-ub[0]);
  q.b0[c] = b0;
  q.lp0[c] = prior_lp(b0, p);
  q.stepdir[c] = 0;
  q.n_shrink[c] = 0;
  if (p.slice == SLICE_QUANTILE) {
    const Pseudo ps = pseudo_at(q, p, row);
    q.w[c] = clamp_t(pseudo_cdf(b0, ps, p), U_LO, U_HI);
    q.L[c] = 0.f;
    q.R[c] = 1.f;
    q.budL[c] = 0;
    q.budR[c] = 0;
    q.xprop[c] = ub[1];
    q.phase[c] = 1;
    return;
  }
  const float w = expf(q.logw[row]);
  const float L = __fsub_rn(b0, __fmul_rn(w, ub[1]));
  const float R = __fadd_rn(L, w);
  const int J = (int)floorf(__fmul_rn(ub[2], (float)p.max_stepouts));
  q.w[c] = w;
  q.L[c] = L;
  q.R[c] = R;
  if (shrink_only) {  // Neal's procedure with a step-out budget of 1
    q.budL[c] = 0;
    q.budR[c] = 0;
    q.phase[c] = 1;
    q.xprop[c] = __fadd_rn(L, __fmul_rn(__fsub_rn(R, L), ub[2]));
  } else {
    q.budL[c] = J;
    q.budR[c] = (p.max_stepouts - 1) - J;
    q.phase[c] = 0;
    q.xprop[c] = L;
  }
}

__global__ void __launch_bounds__(THREADS)
    pass_advance_kernel(Ptrs q, Params p) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  bool record = false;
  int slot = 0;
  if (c < p.C) {
    const int K = p.K, d = p.d;
    const bool active = q.act[c] != 0;
    const int jj = q.j[c], ph = q.phase[c], sd = q.stepdir[c];
    const int ns = q.n_shrink[c], bL = q.budL[c], bR = q.budR[c];
    const float level = q.level[c], ld0 = q.ld0[c], b0 = q.b0[c];
    const float L = q.L[c], R = q.R[c], w = q.w[c];
    const int rem = max(p.max_shrink - ns, 0);
    const size_t row = (size_t)c * K;
    // f as the battery's replay rounds it; the first non-ascent (stepping)
    // and the first acceptor below rem (shrinking)
    int m_na = K, idx = -1;
    for (int k = 0; k < K; ++k) {
      const float f =
          __fadd_rn(__fsub_rn(q.lsum[row + k], ld0), q.fprior[row + k]);
      if (m_na == K && !(f > level)) m_na = k;
      if (idx < 0 && f >= level && k < rem) idx = k;
    }
    const bool any_acc = idx >= 0;
    if (!any_acc) idx = 0;
    const bool stepping = ph == 0, shrinking = ph == 1, left = sd == 0;

    // stepping-out: the battery consumed along the keep-stepping path
    const int moves = min(min(m_na, left ? bL : bR), K);
    const bool done_dir = moves < K;
    const int consumed_step = min(moves, K - 1) + 1;
    const float mw = __fmul_rn((float)moves, w);
    const float L_step = left ? __fsub_rn(L, mw) : L;
    const float R_step = left ? R : __fadd_rn(R, mw);

    // shrinkage: the first acceptor, else the bracket after the last
    // rejection consumed
    const int consumed_sh = any_acc ? idx + 1 : min(rem, K);
    const bool accept = shrinking && any_acc && active;
    const bool exhausted = shrinking && !any_acc &&
                           ns + consumed_sh >= p.max_shrink && active;
    const int last = min(max(consumed_sh - 1, 0), K - 1);
    const bool commit = accept || exhausted;

    // the commit: the accepted proposal, or b0 on exhaustion
    const size_t brow = (size_t)c * d;
    const float b_star = accept ? q.xs[row + idx] : b0;
    q.beta[brow + jj] = b_star;
    // refresh the cache with the accepted proposal's fresh sum
    q.ld0[c] = accept ? q.lsum[row + idx] : ld0;
    if (p.adapt && accept) {
      if (p.slice == SLICE_STEPPING_OUT) {
        // log w_j toward log(adapt_c * accepted move)
        const float move = fabsf(__fsub_rn(b_star, b0));
        const float target =
            logf(__fadd_rn(__fmul_rn(move, p.adapt_c), ADAPT_EPS));
        const float lw = q.logw[brow + jj];
        q.logw[brow + jj] = __fadd_rn(__fmul_rn(lw, p.keep_rate),
                                      __fmul_rn(target, p.rate));
      } else if (p.q_adapt) {
        // the pseudo-target: loc toward the draw, log scale toward
        // log(pseudo_c * |draw - loc|)
        const float ql = q.qloc[brow + jj], lw = q.logw[brow + jj];
        const float target = logf(__fadd_rn(
            __fmul_rn(fabsf(__fsub_rn(b_star, ql)), p.q_c), ADAPT_EPS));
        q.qloc[brow + jj] = __fadd_rn(__fmul_rn(ql, p.keep_rate),
                                      __fmul_rn(b_star, p.rate));
        q.logw[brow + jj] = __fadd_rn(__fmul_rn(lw, p.keep_rate),
                                      __fmul_rn(target, p.rate));
      }
    }
    const int nev =
        q.nev[c] + (active ? (stepping ? consumed_step : consumed_sh) : 0);
    q.nev[c] = nev;

    // the coordinate and the sweep
    int jn = commit ? jj + 1 : jj;
    const bool sweep_done = commit && jn >= d;
    int sc = q.sc[c];
    if (sweep_done && q.draws != nullptr && sc < p.S) {
      record = true;
      slot = sc;
      q.nevbuf[(size_t)c * p.S + sc] = nev;
    }
    if (sweep_done) {
      ++sc;
      jn = 0;
    }
    q.sc[c] = sc;
    q.j[c] = jn;
    if (commit) {
      const bool so = p.begin == BEGIN_PER_LANE ? (long long)sc >= *q.stepout
                                                : p.begin == BEGIN_SHRINK;
      begin_coord(q, p, c, jn, so, q.u + (size_t)c * (K + N_BEGIN) + K);
    } else if (active) {  // idle lanes keep every register
      q.phase[c] = (stepping && !left && done_dir) ? 1 : ph;
      q.stepdir[c] = (stepping && left && done_dir) ? 1 : sd;
      q.L[c] = stepping ? L_step : q.Ls[row + last];
      q.R[c] = stepping ? R_step : q.Rs[row + last];
      q.budL[c] = left ? bL - moves : bL;
      q.budR[c] = left ? bR : bR - moves;
      q.n_shrink[c] = shrinking ? ns + consumed_sh : ns;
    }
  }
  // a finished sweep's draw: the warp copies each such chain's beta row
  __syncwarp();
  unsigned todo = __ballot_sync(0xffffffffu, record);
  while (todo != 0u) {
    const int lane = __ffs(todo) - 1;
    todo &= todo - 1;
    const int cc = blockIdx.x * THREADS + lane;
    const int s = __shfl_sync(0xffffffffu, slot, lane);
    const float* src = q.beta + (size_t)cc * p.d;
    float* dst = q.draws + ((size_t)cc * p.S + s) * p.d;
    for (int i = threadIdx.x; i < p.d; i += THREADS) dst[i] = src[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (*q.flag != 0) {  // some lane was active: the pass counts
      *q.ctr += 1;
      *q.budget -= 1;
    }
    *q.flag = 0;
  }
}

bool unpack(const void* const* ptrs, const int* ints, const float* floats,
            Ptrs* q, Params* p) {
  memcpy(q, ptrs, sizeof(Ptrs));
  memcpy(p, ints, N_INTS * sizeof(int));
  memcpy(reinterpret_cast<char*>(p) + offsetof(Params, q_loc), floats,
         N_FLOATS * sizeof(float));
  return p->C >= 1 && p->d >= 1 && p->K >= 2 && p->K <= KMAX && p->S >= 0 &&
         (p->slice == SLICE_STEPPING_OUT || p->slice == SLICE_QUANTILE) &&
         p->prior >= PRIOR_NORMAL && p->prior <= PRIOR_UNIFORM;
}

template <typename Kernel>
int launch(Kernel kernel, const void* const* ptrs, const int* ints,
           const float* floats, void* stream) {
  Ptrs q;
  Params p;
  if (!unpack(ptrs, ints, floats, &q, &p)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((p.C + THREADS - 1) / THREADS);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(q, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: ``ptrs`` the host
// array of the N_PTRS device pointers in Ptrs' order, ``ints`` and
// ``floats`` host arrays of Params' N_INTS and N_FLOATS fields.  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int pass_propose(const void* const* ptrs, const int* ints,
                            const float* floats, void* stream) {
  return launch(pass_propose_kernel, ptrs, ints, floats, stream);
}

extern "C" int pass_advance(const void* const* ptrs, const int* ints,
                            const float* floats, void* stream) {
  return launch(pass_advance_kernel, ptrs, ints, floats, stream);
}
