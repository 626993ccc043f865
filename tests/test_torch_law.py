"""The port's sampler in law against closed forms: the mirror of the JAX
package's oracle tests (tests/test_freerun_spec.py:35 and
tests/test_freerun_elliptical.py:301-330), run on the CPU through the
plain battery (tests/test_torch_law_counts.py holds the checks against
the JAX engine)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402


def _gaussian_problem(n=400, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta_true = np.linspace(1.0, -0.5, d)
    y = X @ beta_true + rng.normal(size=n)
    P = X.T @ X + np.eye(d)
    mu = np.linalg.solve(P, X.T @ y)
    sd = np.sqrt(np.diag(np.linalg.inv(P)))
    return X, y, mu, sd


@pytest.mark.parametrize("shrink_only", [True, False])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_gaussian_conjugate_recovery(shrink_only, spec_k):
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    fr = mt.FreeRunCGGibbs(
        X, y, "gaussian", mt.IIDPrior(mt.Normal(0.0, 1.0), d),
        extra={"sd": 1.0}, tuning={"w": 0.7}, shrink_only=shrink_only,
        spec_k=spec_k, device="cpu",
    )
    st = fr.init(1, 16)
    st, _, _ = fr.warmup(st, 100)
    st, draws, _ = fr.run(st, 400)
    post = draws.numpy()[:, 100:, :].reshape(-1, d)
    assert np.abs(post.mean(0) - mu).max() < 0.02
    assert np.abs(post.std(0) / sd - 1.0).max() < 0.08


class TestAdaptedQuantile:
    """pseudo_adapt=True: per-(chain, coordinate) pseudo-target loc/scale
    tuned during warmup and frozen for sampling; the collected law must
    match the conjugate oracle."""

    TUN = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 5.0}

    @pytest.fixture(scope="class")
    def problem(self):
        rng = np.random.default_rng(0)
        n, d = 300, 4
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
        cov = np.linalg.inv(X.T @ X + np.eye(d))
        return X, y, cov @ (X.T @ y), cov

    def test_matches_oracle_and_freezes(self, problem):
        X, y, mean, cov = problem
        d = X.shape[1]
        eng = mt.FreeRunCGGibbs(
            X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
            extra={"sd": 1.0}, slice_kernel="quantile", tuning=self.TUN,
            spec_k=4, device="cpu",
        )
        st = eng.init(0, 8)
        st, _, _ = eng.warmup(st, 50)
        st, draws, _ = eng.run(st, 300)
        post = draws.numpy()[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(post.std(0), np.sqrt(np.diag(cov)),
                                   rtol=0.15)
        # frozen: a sampling run must not move the pseudo-target buffers
        st2, _, _ = eng.run(st, 5)
        assert torch.equal(st2.qloc, st.qloc)
        assert torch.equal(st2.logw, st.logw)
        # the adapted locs track the conditional centers
        np.testing.assert_allclose(st.qloc.numpy().mean(0), mean, atol=0.15)
