"""The port's batched slice kernels (``mcmcglm_tpu_torch/ops/
slice_kernels.py``): each kernel run as a Markov chain on known 1-D
targets must reproduce the target (KS test and mean, the JAX package's
tests/test_slice_kernels.py), and the batched form must keep the vmap
semantics: every lane equals that lane run alone (its draws, its own
evaluation count), and the results do not depend on the loop block
length."""

import numpy as np
import pytest
import scipy.stats as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.ops.philox import counter_uniforms, key_tensor  # noqa: E402
from mcmcglm_tpu_torch.ops.slice_kernels import SliceRNG  # noqa: E402

KER_PARAMS = [
    ("stepping_out", {"w": 1.0}),
    ("stepping_out_batched", {"w": 1.0, "K": 4}),
    ("doubling", {"w": 0.8}),
    ("elliptical", {"mu": 0.0, "sigma": 2.0}),
    ("genelliptical", {"mu": 0.0, "sigma": 2.0, "df": 5.0}),
    ("latent", {"rate": 0.5}),
    ("quantile", {"pseudo_loc": 0.0, "pseudo_scale": 2.0}),
]


def _std_normal(x):
    return -0.5 * x * x


def _gamma23(x):
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-30)) - 3.0 * x,
                       -torch.inf)


TARGETS = [("std_normal", _std_normal, st.norm()),
           ("gamma23", _gamma23, st.gamma(2.0, scale=1 / 3.0))]


def run_chain(name, tuning, log_target, x_init, n_steps, seed, n_chains=64,
              block=2):
    """n_steps kernel updates of n_chains float64 chains; step s reads the
    counter (0, s, c, t) of ``seed`` (drawn ahead in one call)."""
    kernel = mt.get_slice_kernel(name)
    W = kernel.n_uniforms(tuning)
    key = key_tensor(seed, "cpu")
    table = counter_uniforms(key, 0, torch.arange(n_steps), n_chains,
                             torch.arange(W))
    x = torch.full((n_chains,), float(x_init), dtype=torch.float64)
    state = torch.full((n_chains,), float(kernel.init_state(tuning)),
                       dtype=torch.float64)
    xs, nevs = [], []
    for s in range(n_steps):
        rng = SliceRNG(key, (0, s), n_chains, table=table[s], block=block)
        res = kernel(rng, x, log_target, state=state, **tuning)
        x, state = res.x, res.state
        xs.append(x)
        nevs.append(res.n_evals)
    return torch.stack(xs, 1).numpy(), torch.stack(nevs, 1).numpy()


@pytest.mark.parametrize("kernel_name,tuning", KER_PARAMS)
@pytest.mark.parametrize("target_name,log_target,ref", TARGETS)
def test_kernel_matches_target(kernel_name, tuning, target_name, log_target,
                               ref):
    # the JAX test's 400 steps cut to 250 (doubling, whose back-test makes
    # each step several loops, to 150): the pooled draws below are still
    # 24-40 per chain, thinned by 5 after a burn-in of a fifth
    n_steps = 150 if kernel_name == "doubling" else 250
    xs, nev = run_chain(kernel_name, tuning, log_target, 1.0, n_steps, seed=3)
    pooled = xs[:, n_steps // 5::5].reshape(-1)
    d, pval = st.kstest(pooled[::7], ref.cdf)
    assert pval > 1e-4, f"{kernel_name} on {target_name}: KS p={pval}, D={d}"
    assert abs(np.mean(pooled) - ref.mean()) < 5 * ref.std() / np.sqrt(200)
    assert (nev > 0).all()


def test_relative_target_fx0_semantics():
    """Passing fx0 equals letting the kernel evaluate it, one evaluation
    fewer."""
    def log_target(x):
        return -0.5 * (x - 1.0) ** 2

    kernel = mt.get_slice_kernel("stepping_out")
    x0 = torch.full((4,), 0.3, dtype=torch.float64)
    r1 = kernel(SliceRNG.from_seed(0, 0, 4, device="cpu"), x0, log_target,
                w=1.0)
    r2 = kernel(SliceRNG.from_seed(0, 0, 4, device="cpu"), x0, log_target,
                fx0=log_target(x0), w=1.0)
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(r2.n_evals.numpy(), r1.n_evals.numpy() - 1)


def test_chains_independent():
    kernel = mt.get_slice_kernel("stepping_out")
    x0 = torch.linspace(-1.0, 1.0, 8, dtype=torch.float64)
    out = kernel(SliceRNG.from_seed(7, 0, 8, device="cpu"), x0, _std_normal,
                 w=1.0).x
    assert len(np.unique(out.numpy())) == 8


def test_bounded_worst_case():
    """A target flat on a point terminates through the shrink budget and
    keeps the current point."""
    def log_target(x):
        return torch.where(torch.abs(x) < 1e-9, 0.0, -torch.inf)

    kernel = mt.get_slice_kernel("stepping_out")
    x0 = torch.zeros(3, dtype=torch.float64)
    res = kernel(SliceRNG.from_seed(0, 0, 3, device="cpu"), x0, log_target,
                 w=0.5)
    assert (res.x.abs() < 1e-9).all()
    # f(x0) and both ends (below the level: no step), then at most the 64
    # shrinks of the budget
    assert ((res.n_evals > 3) & (res.n_evals <= 3 + 64)).all()


@pytest.mark.parametrize("kernel_name,tuning", KER_PARAMS)
def test_block_length_and_lanes_alone(kernel_name, tuning):
    """The same draws at loop block lengths 1, 2 and 5, bitwise; and each
    lane of a batched update equals that lane updated alone (C = 1, its
    own row of the uniforms), with its own evaluation count."""
    runs = [run_chain(kernel_name, tuning, _gamma23, 0.7, 6, seed=11,
                      n_chains=5, block=b) for b in (1, 2, 5)]
    for xs, nev in runs[1:]:
        np.testing.assert_array_equal(xs, runs[0][0])
        np.testing.assert_array_equal(nev, runs[0][1])
    kernel = mt.get_slice_kernel(kernel_name)
    W = kernel.n_uniforms(tuning)
    key = key_tensor(5, "cpu")
    table = counter_uniforms(key, 0, 0, 5, torch.arange(W))
    x0 = torch.tensor([0.05, 0.4, 0.9, 2.0, 5.0], dtype=torch.float64)
    s0 = torch.full((5,), float(kernel.init_state(tuning)), dtype=torch.float64)
    both = kernel(SliceRNG(key, (0, 0), 5, table=table), x0, _gamma23,
                  state=s0, **tuning)
    for c in range(5):
        alone = kernel(SliceRNG(key, (0, 0), 1, table=table[c:c + 1]),
                       x0[c:c + 1], _gamma23, state=s0[c:c + 1], **tuning)
        assert float(alone.x) == float(both.x[c])
        assert int(alone.n_evals) == int(both.n_evals[c])
        assert float(alone.state) == float(both.state[c])


def test_table_and_lazy_draws_agree():
    """A slot past the drawn-ahead table is drawn when read, with the same
    value as the table's."""
    key = key_tensor(2, "cpu")
    table = counter_uniforms(key, 4, 9, 6, torch.arange(10))
    rng = SliceRNG(key, (4, 9), 6, table=table[:, :3])
    for t in (0, 2, 3, 9):
        np.testing.assert_array_equal(rng.uniform(t).numpy(),
                                      table[:, t].numpy())
    np.testing.assert_array_equal(rng.shifted(5).uniforms(1, 3).numpy(),
                                  table[:, 6:9].numpy())


def test_registry():
    assert {"stepping_out", "stepping_out_batched", "doubling", "elliptical",
            "genelliptical", "latent", "quantile"} <= set(mt.SLICE_KERNELS)
    with pytest.raises(ValueError, match="unknown slice kernel"):
        mt.get_slice_kernel("nope")

    def my_kernel(rng, x0, log_target, w, fx0=None, state=None):
        return mt.slice_stepping_out(rng, x0, log_target, w, fx0=fx0)

    bare = mt.get_slice_kernel(my_kernel)
    assert bare.name == "my_kernel" and bare.required == ()
    k = mt.register_slice_kernel(mt.SliceKernel("my_registered", my_kernel,
                                                ("w",)))
    try:
        assert mt.get_slice_kernel("my_registered") is k
        x0 = torch.zeros(4, dtype=torch.float64)
        rng = [SliceRNG.from_seed(1, 0, 4, device="cpu") for _ in range(2)]
        a = k(rng[0], x0, _std_normal, w=1.0)
        b = mt.slice_stepping_out(rng[1], x0, _std_normal, w=1.0)
        np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
    finally:
        del mt.SLICE_KERNELS["my_registered"]
