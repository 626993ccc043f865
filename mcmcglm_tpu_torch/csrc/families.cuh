// Per-observation GLM log densities shared by the port's CUDA kernels
// (freerun_battery.cu, fused_cggibbs.cu).
//
// ld_rel<FAM>(e, y, p) is a family's log density in the linear predictor
// e UP TO an e-independent constant per observation: the samplers only
// compare log densities across e (slice levels, differences against a
// cache), so the constants cancel.  p is the family's scalar extra
// argument (gaussian sd, negative-binomial size, gamma shape).  Products
// and sums that the PyTorch versions round separately are written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into an FMA.
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
};

// X(FAM) once for every id above, for switch statements over the runtime id
#define MCMCGLM_FOR_EACH_FAMILY(X)                                       \
  X(mcmcglm::FAM_GAUSSIAN_IDENTITY)                                    \
  X(mcmcglm::FAM_BINOMIAL_LOGIT)                                       \
  X(mcmcglm::FAM_POISSON_LOG)                                          \
  X(mcmcglm::FAM_NEGBIN_LOG)                                           \
  X(mcmcglm::FAM_GAMMA_LOG)                                            \
  X(mcmcglm::FAM_BINOMIAL_CLOGLOG)

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

}  // namespace mcmcglm
