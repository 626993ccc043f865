"""The port's native C++ ESS (its own copy of the ESS of the JAX package's
``native/hostutils.cpp``, built with g++ at first use) against the port's
numpy version, mirroring tests/test_native.py.  Tolerance: rtol 1e-10 (the
same algorithm in another summation order)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from mcmcglm_tpu_torch import native  # noqa: E402
from mcmcglm_tpu_torch.diagnostics import ess  # noqa: E402


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("no C++ toolchain available")
    return lib


def ar1(rng, C, K, D, rho):
    x = np.zeros((C, K, D))
    x[:, 0] = rng.normal(size=(C, D))
    innov = rng.normal(size=(C, K, D)) * np.sqrt(1 - rho**2)
    for t in range(1, K):
        x[:, t] = rho * x[:, t - 1] + innov[:, t]
    return x


class TestNativeESS:
    def test_matches_numpy(self, lib):
        rng = np.random.default_rng(0)
        x = ar1(rng, 6, 800, 5, 0.6)
        got = native.ess_bulk(x)
        ref = ess(x, use_native=False)
        np.testing.assert_allclose(got, ref, rtol=1e-10)

    def test_iid(self, lib):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(4, 1000, 3))
        got = native.ess_bulk(x)
        ref = ess(x, use_native=False)
        np.testing.assert_allclose(got, ref, rtol=1e-10)

    def test_strong_autocorrelation(self, lib):
        # a long lag window: the Geyer sums run far before they stop
        rng = np.random.default_rng(4)
        x = ar1(rng, 4, 1500, 7, 0.95)
        got = native.ess_bulk(x)
        ref = ess(x, use_native=False)
        assert (got < 0.2 * x.shape[0] * x.shape[1]).all()
        np.testing.assert_allclose(got, ref, rtol=1e-10)

    def test_2d_input(self, lib):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(4, 500))
        got = native.ess_bulk(x)
        assert got.shape == (1,)
        np.testing.assert_allclose(got[0], ess(x, use_native=False),
                                   rtol=1e-10)

    def test_dispatch_threshold(self, lib, monkeypatch):
        import mcmcglm_tpu_torch.diagnostics as diag

        rng = np.random.default_rng(3)
        x = rng.normal(size=(4, 600, 2))
        calls = []
        real = native.ess_bulk
        monkeypatch.setattr(native, "ess_bulk",
                            lambda s: calls.append(s.shape) or real(s))
        monkeypatch.setattr(diag, "_NATIVE_THRESHOLD", 1)
        got = diag.ess(x)  # now routed through native
        assert calls == [(4, 600, 2)]
        ref = diag.ess(x, use_native=False)
        np.testing.assert_allclose(got, ref, rtol=1e-10)
        # a 2-D input comes back as a float, as from the numpy path
        got2 = diag.ess(x[:, :, 0])
        assert isinstance(got2, float)
        assert got2 == pytest.approx(diag.ess(x[:, :, 0], use_native=False),
                                     rel=1e-10)

    def test_below_the_threshold_stays_numpy(self, lib, monkeypatch):
        import mcmcglm_tpu_torch.diagnostics as diag

        monkeypatch.setattr(native, "ess_bulk",
                            lambda s: pytest.fail("native below threshold"))
        x = np.random.default_rng(5).normal(size=(4, 100, 2))
        assert x.size < diag._NATIVE_THRESHOLD
        diag.ess(x)

    def test_the_library_lives_in_the_build_tree(self, lib):
        path = native._library_path()
        assert path.exists() and path.parts[-3:-1] == (
            "mcmcglm_tpu_torch", path.parent.name)
        assert path.parent.parent.parent.name == "build"
