// Native host-side diagnostics for mcmcglm_tpu_torch: the port's own copy
// of mcmcglm_tpu/native/hostutils.cpp (the port cannot import the JAX
// package, whose __init__ loads jax).
//
// Why native: pooled convergence diagnostics over many chains are a
// host-side cost — the per-parameter ESS requires an autocovariance scan
// over every (chain, parameter) series.  This C++ implementation computes
// Geyer-truncated ESS with OpenMP over parameters and early lag
// termination, avoiding the numpy FFT path's full-K transforms for series
// whose correlation dies after a few lags (the common CGGibbs case).  It
// runs on the host CPU, never on the GPU.
//
// The algorithms mirror mcmcglm_tpu_torch/diagnostics.py exactly (split
// chains, chain-mean variance correction, Geyer initial monotone positive
// sequence); tests/test_torch_native.py asserts parity with the numpy
// version.
//
// Built at first use with g++ -O3 -fPIC -shared -fopenmp (see
// native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// samples: row-major (C, K, D).  out_ess: (D).  Returns 0 on success.
int ess_bulk(const double* samples, int64_t C, int64_t K, int64_t D,
             double* out_ess) {
  if (C < 1 || K < 4 || D < 1) {
    for (int64_t p = 0; p < D; ++p) out_ess[p] = (double)(C * K);
    return 0;
  }
  const int64_t half = K / 2;           // split each chain in two
  const int64_t C2 = 2 * C;
  const int64_t Ks = half;              // draws per split chain

#pragma omp parallel for schedule(dynamic)
  for (int64_t p = 0; p < D; ++p) {
    // gather split-chain views: chain c half h -> base offset
    std::vector<double> mean(C2), var(C2);
    std::vector<const double*> base(C2);
    std::vector<int64_t> stride(C2);
    for (int64_t c = 0; c < C; ++c) {
      base[2 * c] = samples + (c * K + 0) * D + p;
      base[2 * c + 1] = samples + (c * K + (K - half)) * D + p;
      stride[2 * c] = D;
      stride[2 * c + 1] = D;
    }
    // per split-chain mean and variance (ddof=1)
    double mean_var = 0.0, grand_mean = 0.0;
    for (int64_t c = 0; c < C2; ++c) {
      double m = 0.0;
      for (int64_t t = 0; t < Ks; ++t) m += base[c][t * stride[c]];
      m /= (double)Ks;
      mean[c] = m;
      double v = 0.0;
      for (int64_t t = 0; t < Ks; ++t) {
        double dlt = base[c][t * stride[c]] - m;
        v += dlt * dlt;
      }
      var[c] = v / (double)(Ks - 1);
      mean_var += var[c];
      grand_mean += m;
    }
    mean_var /= (double)C2;
    grand_mean /= (double)C2;

    double var_plus = mean_var * (double)(Ks - 1) / (double)Ks;
    if (C2 > 1) {
      double b = 0.0;
      for (int64_t c = 0; c < C2; ++c) {
        double dlt = mean[c] - grand_mean;
        b += dlt * dlt;
      }
      var_plus += b / (double)(C2 - 1);
    }
    const double total = (double)(C2 * Ks);
    if (!(var_plus > 0.0) || !std::isfinite(var_plus)) {
      out_ess[p] = total;
      continue;
    }

    // mean autocovariance across split chains at lag t, computed lazily
    // with Geyer paired-sum early termination.
    auto mean_acov = [&](int64_t lag) {
      double acc = 0.0;
      for (int64_t c = 0; c < C2; ++c) {
        const double* x = base[c];
        const int64_t s = stride[c];
        const double m = mean[c];
        double a = 0.0;
        for (int64_t t = 0; t + lag < Ks; ++t)
          a += (x[t * s] - m) * (x[(t + lag) * s] - m);
        acc += a / (double)Ks;
      }
      return acc / (double)C2;
    };

    const double acov0 = mean_acov(0);
    const double w = acov0 * (double)Ks / (double)(Ks - 1);
    auto rho = [&](int64_t lag) {
      if (lag == 0) return 1.0;
      return 1.0 - (w - mean_acov(lag)) / var_plus;
    };

    const int64_t max_pairs = (Ks - 1) / 2;
    double tau = 0.0, prev_pair = INFINITY;
    int64_t used = 0;
    for (int64_t t = 0; t < max_pairs; ++t) {
      double pair = rho(2 * t) + rho(2 * t + 1);
      if (pair <= 0.0) break;
      if (pair > prev_pair) pair = prev_pair;  // monotone decrease
      tau += pair;
      prev_pair = pair;
      ++used;
    }
    double tau_f = used ? (-1.0 + 2.0 * tau) : 1.0;
    const double tau_min = 1.0 / std::log10(total + 10.0);
    if (tau_f < tau_min) tau_f = tau_min;
    double ess = total / tau_f;
    const double cap = total * std::log10(total + 10.0);
    if (ess > cap) ess = cap;
    out_ess[p] = ess;
  }
  return 0;
}

}  // extern "C"
