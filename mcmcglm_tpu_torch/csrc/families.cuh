// Per-observation GLM log densities shared by the port's CUDA kernels
// (freerun_battery.cu, fused_cggibbs.cu).
//
// ld_rel<FAM>(e, y, p) is a family's log density in the linear predictor
// e UP TO an e-independent constant per observation: the samplers only
// compare log densities across e (slice levels, differences against a
// cache), so the constants cancel.  p is the family's scalar extra
// argument (gaussian sd, negative-binomial size, gamma shape,
// inverse-gaussian dispersion).  Products and sums that the PyTorch
// versions round separately are written with __fmul_rn / __fadd_rn so that
// nvcc cannot contract them into an FMA.
//
// Six pairs have a fused path of their own (FAM_GAUSSIAN_IDENTITY ..
// FAM_BINOMIAL_CLOGLOG).  Every other built-in family/link pair takes the
// composed route, one template id (FAM_COMPOSED) whose family and link are
// runtime ids (Composed), uniform across a launch: mu = linkinv(link, e),
// then the family's relative density of mu with the clamps of the JAX
// package's *_rel functions (Family.log_density_eta_rel,
// mcmcglm_tpu/models/families.py).  binomial has no relative form: probit
// is log Phi(+-e), cauchit and log the clamped Bernoulli log pdf of mu.
// The clamps propagate NaN, as torch.clamp and jnp.maximum do.  The
// kernels' loops call ld_rel<FAM> for the six; for FAM_COMPOSED they run
// inside with_pair, which matches the runtime ids once, outside the loop,
// and hands the loop the density of that one pair as a functor, so that
// the loop runs the pair's straight-line code (a switch inside the loop
// cuts every unrolled body into branches and serialises the evaluations:
// batteries 2.3-4.5x slower on an H100).
#pragma once

namespace mcmcglm {

// family/link ids: keep in step with KERNEL_FAMILIES in
// mcmcglm_tpu_torch/ops/freerun_batteries.py
enum : int {
  FAM_GAUSSIAN_IDENTITY = 0,
  FAM_BINOMIAL_LOGIT = 1,
  FAM_POISSON_LOG = 2,
  FAM_NEGBIN_LOG = 3,
  FAM_GAMMA_LOG = 4,
  FAM_BINOMIAL_CLOGLOG = 5,
  FAM_COMPOSED = 6,
};

// runtime ids of the composed route: keep in step with COMPOSED_FAMILIES
// and COMPOSED_LINKS in mcmcglm_tpu_torch/ops/freerun_batteries.py
enum : int {
  RF_GAUSSIAN = 0,
  RF_BINOMIAL = 1,
  RF_POISSON = 2,
  RF_NEGBIN = 3,
  RF_GAMMA = 4,
  RF_INVGAUSS = 5,
};
enum : int {
  LINK_IDENTITY = 0,
  LINK_LOG = 1,
  LINK_LOGIT = 2,
  LINK_PROBIT = 3,
  LINK_CLOGLOG = 4,
  LINK_INVERSE = 5,
  LINK_INV_SQUARE = 6,  // "1/mu^2"
  LINK_SQRT = 7,
  LINK_CAUCHIT = 8,
};

// the composed route's runtime family and link (ignored by the six)
struct Composed {
  int fam, link;
};

// the fifteen pairs of the composed route, X(family id, link id): keep in
// step with KERNEL_FAMILIES in mcmcglm_tpu_torch/ops/freerun_batteries.py
#define MCMCGLM_FOR_EACH_COMPOSED_PAIR(X)                                \
  X(RF_GAUSSIAN, LINK_LOG)                                              \
  X(RF_GAUSSIAN, LINK_INVERSE)                                          \
  X(RF_BINOMIAL, LINK_PROBIT)                                           \
  X(RF_BINOMIAL, LINK_CAUCHIT)                                          \
  X(RF_BINOMIAL, LINK_LOG)                                              \
  X(RF_POISSON, LINK_IDENTITY)                                          \
  X(RF_POISSON, LINK_SQRT)                                              \
  X(RF_NEGBIN, LINK_SQRT)                                               \
  X(RF_NEGBIN, LINK_IDENTITY)                                           \
  X(RF_GAMMA, LINK_INVERSE)                                             \
  X(RF_GAMMA, LINK_IDENTITY)                                            \
  X(RF_INVGAUSS, LINK_INV_SQUARE)                                       \
  X(RF_INVGAUSS, LINK_INVERSE)                                          \
  X(RF_INVGAUSS, LINK_IDENTITY)                                         \
  X(RF_INVGAUSS, LINK_LOG)

// whether the runtime ids name one of the fifteen (the launchers refuse
// any other with cudaErrorInvalidValue)
inline bool composed_pair_ok(Composed c) {
#define MCMCGLM_PAIR_OK(RF, LINK) \
  if (c.fam == RF && c.link == LINK) return true;
  MCMCGLM_FOR_EACH_COMPOSED_PAIR(MCMCGLM_PAIR_OK)
#undef MCMCGLM_PAIR_OK
  return false;
}

// X(FAM) once for every id above, for switch statements over the runtime id
#define MCMCGLM_FOR_EACH_FAMILY(X)                                       \
  X(mcmcglm::FAM_GAUSSIAN_IDENTITY)                                    \
  X(mcmcglm::FAM_BINOMIAL_LOGIT)                                       \
  X(mcmcglm::FAM_POISSON_LOG)                                          \
  X(mcmcglm::FAM_NEGBIN_LOG)                                           \
  X(mcmcglm::FAM_GAMMA_LOG)                                            \
  X(mcmcglm::FAM_BINOMIAL_CLOGLOG)                                     \
  X(mcmcglm::FAM_COMPOSED)

// softplus(x) = log(1 + exp(x)), spelled as torch.logaddexp(x, 0) computes it
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

template <int FAM>
__device__ __forceinline__ float ld_rel(float e, float y, float p) {
  if (FAM == FAM_GAUSSIAN_IDENTITY) {  // -0.5 z^2, z = (y - e) / sd
    const float z = __fdiv_rn(__fsub_rn(y, e), p);
    return __fmul_rn(__fmul_rn(-0.5f, z), z);
  } else if (FAM == FAM_BINOMIAL_LOGIT) {  // y e - softplus(e)
    return __fsub_rn(__fmul_rn(y, e), softplus(e));
  } else if (FAM == FAM_POISSON_LOG) {  // y e - exp(e)
    return __fsub_rn(__fmul_rn(y, e), expf(e));
  } else if (FAM == FAM_NEGBIN_LOG) {
    // r (log r - lrm) + y (e - lrm), lrm = log r + softplus(e - log r)
    const float log_r = logf(p);
    const float lrm = __fadd_rn(log_r, softplus(__fsub_rn(e, log_r)));
    return __fadd_rn(__fmul_rn(p, __fsub_rn(log_r, lrm)),
                     __fmul_rn(y, __fsub_rn(e, lrm)));
  } else if (FAM == FAM_GAMMA_LOG) {  // -k e - k y exp(-e)
    return __fsub_rn(__fmul_rn(-p, e), __fmul_rn(__fmul_rn(p, y), expf(-e)));
  } else {  // FAM_BINOMIAL_CLOGLOG
    const float ex = expf(e);
    const float tiny = 1.17549435e-38f;
    const float log_mu =
        ex > 1e-3f ? logf(fmaxf(__fsub_rn(1.f, expf(-ex)), tiny))
                   : __fsub_rn(e, __fmul_rn(0.5f, ex));
    return y > 0.5f ? log_mu : -ex;
  }
}

// -- the composed route ---------------------------------------------------

constexpr float F32_TINY = 1.17549435e-38f;  // torch.finfo(float32).tiny
constexpr float F32_EPS = 1.1920929e-07f;    // torch.finfo(float32).eps

// max(v, lo) and min(v, hi) that keep a NaN v, as torch.clamp does
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v > hi ? hi : v;
}

// the inverse link of mcmcglm_tpu_torch/models/links.py, in float32
__device__ __forceinline__ float linkinv(int link, float e) {
  switch (link) {
    case LINK_IDENTITY:
      return e;
    case LINK_LOG:
      return expf(e);
    case LINK_LOGIT:  // torch.sigmoid: 1 / (1 + exp(-e))
      return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-e)));
    case LINK_PROBIT:  // 0.5 erfc(-e / sqrt 2)
      return __fmul_rn(0.5f, erfcf(__fdiv_rn(-e, 1.41421356237309515f)));
    case LINK_CLOGLOG:  // -expm1(-exp(e)) clamped to [eps, 1 - eps]
      return clamp_hi(clamp_lo(-expm1f(-expf(e)), F32_EPS), 1.f - F32_EPS);
    case LINK_INVERSE:
      return __frcp_rn(e);
    case LINK_INV_SQUARE:
      return rsqrtf(e);
    case LINK_SQRT:
      return __fmul_rn(e, e);
    default:  // LINK_CAUCHIT: 0.5 + atan(e) / pi
      return __fadd_rn(0.5f, __fdiv_rn(atanf(e), 3.14159265358979323f));
  }
}

// a family's relative log density in its mean mu (the JAX package's
// *_rel functions; binomial's full Bernoulli log pdf)
__device__ __forceinline__ float ld_rel_mu(int fam, float mu, float y,
                                           float p) {
  switch (fam) {
    case RF_GAUSSIAN: {  // -0.5 z^2, z = (y - mu) / sd
      const float z = __fdiv_rn(__fsub_rn(y, mu), p);
      return __fmul_rn(__fmul_rn(-0.5f, z), z);
    }
    case RF_BINOMIAL: {  // y log mu + (1 - y) log1p(-mu), mu in [tiny, 1 - eps]
      const float m = clamp_hi(clamp_lo(mu, F32_TINY), 1.f - F32_EPS);
      return __fadd_rn(__fmul_rn(y, logf(m)),
                       __fmul_rn(__fsub_rn(1.f, y), log1pf(-m)));
    }
    case RF_POISSON: {  // y log mu - mu
      const float m = clamp_lo(mu, F32_TINY);
      return __fsub_rn(__fmul_rn(y, logf(m)), m);
    }
    case RF_NEGBIN: {  // r (log r - log(r + mu)) + y (log mu - log(r + mu))
      const float m = clamp_lo(mu, F32_TINY);
      const float lrm = logf(__fadd_rn(p, m));
      return __fadd_rn(__fmul_rn(p, __fsub_rn(logf(p), lrm)),
                       __fmul_rn(y, __fsub_rn(logf(m), lrm)));
    }
    case RF_GAMMA: {  // -k log mu - k y / mu
      const float m = clamp_lo(mu, F32_TINY);
      return __fsub_rn(__fmul_rn(-p, logf(m)),
                       __fdiv_rn(__fmul_rn(p, y), m));
    }
    default: {  // RF_INVGAUSS: -(y - mu)^2 / (2 y phi mu mu)
      const float m = clamp_lo(mu, F32_TINY);
      const float r = __fsub_rn(y, m);
      const float den = __fmul_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(2.f, y), p), m), m);
      return __fdiv_rn(-__fmul_rn(r, r), den);
    }
  }
}

// log Phi(x), as torch.special.log_ndtr computes it: through the scaled
// complementary error function below -1, where Phi(x) underflows long
// before its log does (x = -40 gives about -804.6), else log1p of the
// small complement
__device__ __forceinline__ float log_ndtr(float x) {
  const float t = __fmul_rn(x, 0.707106781186547524f);
  if (x < -1.f)
    return __fsub_rn(logf(__fmul_rn(erfcxf(-t), 0.5f)), __fmul_rn(t, t));
  return log1pf(__fmul_rn(-erfcf(t), 0.5f));
}

__device__ __forceinline__ float ld_composed(Composed c, float e, float y,
                                             float p) {
  if (c.fam == RF_BINOMIAL && c.link == LINK_PROBIT)
    return log_ndtr(y > 0.5f ? e : -e);
  return ld_rel_mu(c.fam, linkinv(c.link, e), y, p);
}

// the density of a pair's own path, and of one composed pair, as functors
template <int FAM>
struct LdRel {
  float p;
  __device__ __forceinline__ float operator()(float e, float y) const {
    return ld_rel<FAM>(e, y, p);
  }
};
template <int RF, int LINK>
struct LdPair {
  float p;
  __device__ __forceinline__ float operator()(float e, float y) const {
    return ld_composed(Composed{RF, LINK}, e, y, p);  // the switches fold
  }
};

// f(ld) with the density functor of the composed pair that c names
// (uniform across a launch: one branch per call, outside f's loop; the
// launchers refuse ids outside the fifteen)
template <typename F>
__device__ __forceinline__ void with_pair(Composed c, float p, F&& f) {
#define MCMCGLM_PAIR_CASE(RF, LINK)    \
  if (c.fam == RF && c.link == LINK) { \
    f(LdPair<RF, LINK>{p});            \
    return;                            \
  }
  MCMCGLM_FOR_EACH_COMPOSED_PAIR(MCMCGLM_PAIR_CASE)
#undef MCMCGLM_PAIR_CASE
}

}  // namespace mcmcglm
