"""One pass of the port against one pass of the JAX package, from the same
state and with the same uniforms.

Each step converts the JAX state into the port's (``convert_state``),
rebuilds the reference's uniform block exactly as ``run_pass_spec`` /
``run_pass`` draw it (``key, k_u = jax.random.split(s.key)`` then
``jax.random.uniform(k_u, (C, width), float32)``), runs one pass on each
side and compares; the next step starts again from the JAX result, so
errors never build up.  Integer registers must match exactly and floats
within the stated tolerances.  A lane whose decision differs must have an
f within the battery's float tolerance of its slice level; such lanes are
reported and excluded, never hidden by reseeding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402
from mcmcglm_tpu.ops import freerun_passes as jp  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_passes as tp  # noqa: E402

C, N, D, N_SWEEPS, PASSES = 32, 300, 3, 3, 20
INT_FIELDS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
LD0_TOL = dict(rtol=2e-5, atol=2e-3)  # sums over n: reduction order

QUANTILE = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}
WEIGHTS = np.random.default_rng(9).choice([0.0, 0.5, 1.0, 2.0], size=N)
CASES = {
    # name: (slice_kernel, tuning, adapt, shrink_only, stepout_sweeps,
    #        adaptation passes run before comparing, observation weights)
    "stepping_out_warmup": ("stepping_out", {"w": 0.5}, True, False, 1, 0,
                            None),
    "stepping_out_weighted": ("stepping_out", {"w": 0.5}, False, True, None,
                              0, WEIGHTS),
    "quantile_warmup": ("quantile", QUANTILE, True, False, None, 0, None),
    "quantile_adapted": ("quantile", QUANTILE, False, True, None, 25, None),
}


def _engines(kernel, tuning, spec_k, obs_weights=None):
    X, y, _ = mg.generate_glm_data("binomial", n=N, d=D, seed=4)
    ej = JaxFreeRun(X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), D),
                    tuning=tuning, spec_k=spec_k, slice_kernel=kernel,
                    obs_weights=obs_weights)
    et = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), D),
                           tuning=tuning, spec_k=spec_k, slice_kernel=kernel,
                           obs_weights=obs_weights, device="cpu")
    assert (ej.battery_impl, et.battery_impl) == ("xla", "torch")
    assert ej.eval_cache == et.eval_cache == "scalar"
    return ej, et


def _f_and_level(et, s, u):
    """Per-lane f (C, K') of the pass (K' = 1 for the classic pass)."""
    K = et.spec_k
    if K == 1:  # the classic pass evaluates xprop
        xs = s.xprop[:, None]
        q = tp._pseudo_target(et, s)
        xs_eval = (et.quantile_ppf(xs, None if q[0] is None else q[0][:, None],
                                   None if q[1] is None else q[1][:, None])
                   if et.slice_kernel == "quantile" else xs)
        deltas = xs_eval - s.b0[:, None]
        fprior = et._coord_lp(s.beta, s.j, xs_eval) - s.lp0[:, None]
        if et.slice_kernel == "quantile":
            fprior = fprior + (
                et.quantile_logpdf(s.b0, q[0], q[1])[:, None]
                - et.quantile_logpdf(
                    xs_eval, None if q[0] is None else q[0][:, None],
                    None if q[1] is None else q[1][:, None]))
    else:
        p = tp.spec_proposals(et, s, u[:, :K])
        deltas, fprior = p["deltas"], p["fprior"]
    lsum = fb.plain_battery(s.eta, et.Xt[s.j.long()], deltas, et.y,
                            lambda e, y: et._ld_eta(e, y, et.extra),
                            et.reduce_fn)
    return ((lsum - s.ld0[:, None]) + fprior).numpy(), s.level.numpy(), \
        lsum.numpy()


def _compare(name, got, want, ok, tol):
    got, want = np.asarray(got), np.asarray(want)
    if got.ndim == 0:
        return
    np.testing.assert_allclose(got[ok], want[ok], err_msg=name, **tol)


@pytest.mark.parametrize("spec_k", [4, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_one_pass_matches_jax(case, spec_k):
    kernel, tuning, adapt, shrink_only, stepout, pre, weights = CASES[case]
    ej, et = _engines(kernel, tuning, spec_k, weights)
    jax_pass = jp.run_pass_spec if spec_k > 1 else jp.run_pass
    port_pass = tp.run_pass_spec if spec_k > 1 else tp.run_pass
    assert ej._n_begin_u == et._n_begin_u
    width = spec_k + et._n_begin_u  # (C, K + nb), or (C, 1 + nb) at K=1

    s = ej.init(jax.random.key(3), C)
    rng = np.random.default_rng(5)
    # lanes at different sweep counts, some close to the quota, so that
    # sweeps complete, draws land in their slots and lanes go idle
    sc = jnp.asarray(rng.integers(0, N_SWEEPS, C), jnp.int32)
    draws = jnp.zeros((C, N_SWEEPS, D), jnp.float32)
    nevbuf = jnp.zeros((C, N_SWEEPS), jnp.int32)
    for _ in range(pre):  # adapt the pseudo-targets first
        s, _, _, _ = jax_pass(ej, s, jnp.zeros((C,), jnp.int32), draws,
                              nevbuf, 10**6, True, False, None)

    compared = near_total = 0
    for _ in range(PASSES):
        _, k_u = jax.random.split(s.key)
        u = np.asarray(jax.random.uniform(k_u, (C, width), jnp.float32))
        st = mt.convert_state(s, et)
        sc_t = torch.tensor(np.asarray(sc))
        dr_t = torch.tensor(np.asarray(draws))
        nb_t = torch.tensor(np.asarray(nevbuf))
        f, level, lsum = _f_and_level(et, st, torch.tensor(u))

        s2, sc2, draws2, nevbuf2 = jax_pass(
            ej, s, sc, draws, nevbuf, N_SWEEPS, adapt, shrink_only, stepout)
        t2, sc2_t, dr2_t, nb2_t = port_pass(
            et, st, sc_t, dr_t, nb_t, N_SWEEPS, adapt, shrink_only, stepout,
            u=torch.tensor(u))

        near = (np.abs(f - level[:, None])
                <= LD0_TOL["atol"] + LD0_TOL["rtol"] * np.abs(lsum)).any(1)
        same = np.ones(C, bool)
        for name in INT_FIELDS:
            same &= np.asarray(getattr(s2, name)) == getattr(t2, name).numpy()
        same &= np.asarray(sc2) == sc2_t.numpy()
        # a lane may decide differently only at the float tolerance
        assert not (~same & ~near).any(), (
            f"decisions differ away from the slice level on lanes "
            f"{np.nonzero(~same & ~near)[0]}")
        ok = same & ~near
        near_total += int(near.sum())
        compared += int(ok.sum())
        for name in INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(t2, name).numpy()[ok], np.asarray(getattr(s2, name))[ok],
                err_msg=name)
        for name in et.state_cls._fields:
            if name in INT_FIELDS or name in ("key", "ctr"):
                continue
            tol = LD0_TOL if name == "ld0" else FLOAT_TOL
            _compare(name, getattr(t2, name).numpy(),
                     np.asarray(getattr(s2, name)), ok, tol)
        _compare("draws", dr2_t.numpy(), np.asarray(draws2), ok, FLOAT_TOL)
        np.testing.assert_array_equal(nb2_t.numpy()[ok],
                                      np.asarray(nevbuf2)[ok])
        s, sc, draws, nevbuf = s2, sc2, draws2, nevbuf2

    assert compared >= 0.9 * C * PASSES, (compared, near_total)
    # the run exercised commits, completed sweeps and idle lanes
    assert int(np.asarray(nevbuf).astype(bool).sum()) > 0
    assert int((np.asarray(sc) >= N_SWEEPS).sum()) > 0


@pytest.mark.parametrize("impl", ["pallas", "pallas2", "pallas3"])
def test_convert_state_undoes_pallas_layouts(impl):
    """A state from a Pallas-battery JAX engine (observation axis padded,
    pallas3's (C, S, 128) eta) converts to the same port state as the
    unpadded "xla" engine's."""
    X, y, _ = mg.generate_glm_data("binomial", n=N, d=D, seed=4)
    kw = dict(tuning={"w": 0.5}, spec_k=4, eval_cache="scalar")
    prior = mg.IIDPrior(mg.Normal(0, 1), D)
    ref = JaxFreeRun(X, y, "binomial", prior, battery_impl="xla", **kw)
    pal = JaxFreeRun(X, y, "binomial", prior, battery_impl=impl, **kw)
    et = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), D),
                           device="cpu", **kw)
    s_ref = ref.init(jax.random.key(0), 16)
    s_pal = pal.init(jax.random.key(0), 16)
    if impl == "pallas3":
        assert s_pal.eta.ndim == 3
    a, b = mt.convert_state(s_ref, et), mt.convert_state(s_pal, et)
    assert a.eta.shape == b.eta.shape == (16, N)
    for name in et.state_cls._fields:
        if name == "key":
            continue
        x, z = getattr(a, name), getattr(b, name)
        assert x.dtype == z.dtype
        torch.testing.assert_close(x, z, rtol=2e-6, atol=1e-4)


def test_convert_state_field_mismatch_raises():
    X, y, _ = mg.generate_glm_data("binomial", n=N, d=D, seed=4)
    ej = JaxFreeRun(X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), D),
                    tuning={"w": 0.5})
    et = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), D),
                           slice_kernel="quantile", tuning=QUANTILE,
                           device="cpu")
    with pytest.raises(ValueError, match="qloc"):
        mt.convert_state(ej.init(jax.random.key(0), 4), et)
