"""The port's doubling kernel on a bimodal posterior: the mirror of
tests/test_freerun_doubling.py:97, the sharp check of the Fig. 6
back-test (its mode masses against grid quadrature)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402


def test_bimodal_backtest_mode_masses():
    """Cauchy(0, 0.15) prior against one N(2.2, 1) observation: a bimodal
    1-D posterior with a deep dip.  At w=0.05 the doubled interval spans
    the dip, so the Fig. 6 back-test rejects often; a missing back-test
    would mis-weight the modes.  Mode masses against grid quadrature."""
    X = np.ones((1, 1))
    y = np.full(1, 2.2)
    prior = mt.IIDPrior(mt.StudentT(df=1.0, loc=0.0, scale=0.15), 1)
    g = np.linspace(-6.0, 9.0, 300001)
    lp = -0.5 * (g - 2.2) ** 2 - np.log(1 + (g / 0.15) ** 2)
    p = np.exp(lp - lp.max())
    p /= np.trapezoid(p, g)
    mass_exact = np.cumsum(p)[np.searchsorted(g, 1.0)] * (g[1] - g[0])
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", prior, extra={"sd": 1.0},
                            slice_kernel="doubling", tuning={"w": 0.05},
                            device="cpu")
    st = eng.init(5, 64)
    st, draws, _ = eng.run(st, 2000)
    d_ = draws.numpy()[:, 400:, 0].ravel()
    assert abs((d_ < 1.0).mean() - mass_exact) < 0.01
    assert abs(d_.mean() - np.trapezoid(g * p, g)) < 0.03
