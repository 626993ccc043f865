// Prior ids shared by the port's CUDA kernels (fused_cggibbs.cu,
// freerun_automaton.cu).  KERNEL_PRIORS in ops/fused_cggibbs.py gives each
// IIDPrior distribution its id and the order of its parameters.
#pragma once

namespace mcmcglm {

enum : int {
  PRIOR_NORMAL = 0,       // (loc, scale)
  PRIOR_GAMMA = 1,        // (concentration, rate)
  PRIOR_EXPONENTIAL = 2,  // (rate)
  PRIOR_STUDENT_T = 3,    // (df, loc, scale)
  PRIOR_LAPLACE = 4,      // (loc, scale)
  PRIOR_UNIFORM = 5,      // (low, high)
};

// -inf, a prior's log density outside its support
__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

}  // namespace mcmcglm
