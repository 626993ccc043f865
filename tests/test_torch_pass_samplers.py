"""One pass of the port's latent, elliptical, genelliptical, doubling and
conjugate samplers against one pass of the JAX package, from the same
state and with the same draws (the method of tests/test_torch_pass.py).

Each step converts the JAX state into the port's (``convert_state``),
rebuilds the reference's draws exactly as its pass makes them (``key, k =
jax.random.split(s.key)``; the uniform block ``jax.random.uniform(k, (C,
width))``, genelliptical's Gamma draw from ``fold_in(key, 0x9E11)`` and
the conjugate pass's ``jax.random.normal(k, (C,))``), hands them to the
port's pass, and compares; the next step starts again from the JAX
result.  Integer and boolean registers must match exactly and floats
within the tolerances of tests/test_torch_pass.py; a lane may decide
otherwise only where its f lies within the battery's float tolerance of
its slice level (reported, never hidden).
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
from mcmcglm_tpu.ops import freerun_conjugate as jc  # noqa: E402
from mcmcglm_tpu.ops import freerun_doubling as jd  # noqa: E402
from mcmcglm_tpu.ops import freerun_passes as jp  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_conjugate as tc  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_doubling as td  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_passes as tp  # noqa: E402

C, N, D, N_SWEEPS, PASSES = 32, 300, 3, 3, 18
EXACT_FIELDS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev",
                "e_aL", "e_aR", "h_aL", "h_aR", "dsep")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
LD0_TOL = dict(rtol=2e-5, atol=2e-3)  # sums over n: reduction order
DOUBLING_PASSES = 48

CASES = {
    # name: (engine options, family, adapt, shrink_only, spec_k values);
    # doubling runs DOUBLING_PASSES (its coordinates take more passes)
    "latent": (dict(slice_kernel="latent", tuning={"rate": 0.5}),
               "binomial", False, True, (1, 4)),
    "elliptical": (dict(slice_kernel="elliptical",
                        tuning={"mu": 0.0, "sigma": 2.0}),
                   "binomial", False, True, (1, 4)),
    "genelliptical": (dict(slice_kernel="genelliptical",
                           tuning={"mu": 0.0, "sigma": 2.0, "df": 5.0}),
                      "binomial", False, True, (1, 4)),
    # small w: the lanes double, back-test (phase 2) and commit (phase 3)
    "doubling_small_w": (dict(slice_kernel="doubling",
                              tuning={"w": 0.03}),
                         "binomial", False, False, (1,)),
    "doubling": (dict(slice_kernel="doubling", tuning={"w": 0.5}),
                 "binomial", True, False, (1,)),
    "conjugate": (dict(coord_sampler="conjugate"), "gaussian", True, False,
                  (1,)),
}
PARAMS = [(name, k) for name, case in CASES.items() for k in case[4]]


def _engines(opts, family, spec_k):
    X, y, _ = mg.generate_glm_data(family, n=N, d=D, seed=4)
    extra = {"sd": 1.3} if family == "gaussian" else {}
    kw = dict(opts)
    if opts.get("coord_sampler") != "conjugate":
        kw["spec_k"] = spec_k
    ej = JaxFreeRun(X, y, family, mg.IIDPrior(mg.Normal(0, 1), D),
                    extra=extra, **kw)
    et = mt.FreeRunCGGibbs(X, y, family, mt.IIDPrior(mt.Normal(0, 1), D),
                           extra=extra, device="cpu", **kw)
    assert ej.battery_impl == "xla" and et.battery_impl == "torch"
    assert ej._n_begin_u == et._n_begin_u
    assert ej.eval_cache == et.eval_cache
    return ej, et


def _jax_draws(ej, s, width):
    """The draws of the JAX pass from state ``s``, as numpy arrays."""
    key, k = jax.random.split(s.key)
    if ej.coord_sampler == "conjugate":
        return {"z": np.asarray(jax.random.normal(k, (C,), jnp.float32))}
    out = {"u": np.asarray(jax.random.uniform(k, (C, width), jnp.float32))}
    if ej.slice_kernel == "genelliptical":
        out["g"] = np.asarray(jax.random.gamma(
            jax.random.fold_in(key, 0x9E11), (ej.ell_df + 1.0) / 2.0, (C,),
            dtype=jnp.float32))
    return out


def _f_and_level(et, s, u):
    """Per-lane f (C, K') of the port's pass and the battery's lsum."""
    K = et.spec_k
    if K == 1:
        xs_eval = tp._to_x(et, s, s.xprop[:, None])
    else:
        xs_eval = tp.spec_proposals(et, s, u[:, :K])["xs_eval"]
    deltas = xs_eval - s.b0[:, None]
    fprior = et._coord_lp(s.beta, s.j, xs_eval) - s.lp0[:, None]
    lsum = fb.plain_battery(s.eta, et.Xt[s.j.long()], deltas, et.y,
                            lambda e, y: et._ld_eta(e, y, et.extra),
                            et.reduce_fn)
    return ((lsum - s.ld0[:, None]) + fprior).numpy(), s.level.numpy(), \
        lsum.numpy()


def _passes(et):
    if et.coord_sampler == "conjugate":
        return jc.run_pass_conj, tc.run_pass_conj
    if et.slice_kernel == "doubling":
        return jd.run_pass_doubling, td.run_pass_doubling
    if et.spec_k > 1:
        return jp.run_pass_spec, tp.run_pass_spec
    return jp.run_pass, tp.run_pass


@pytest.mark.parametrize("name,spec_k", PARAMS)
def test_one_pass_matches_jax(name, spec_k):
    opts, family, adapt, shrink_only, _ = CASES[name]
    ej, et = _engines(opts, family, spec_k)
    jax_pass, port_pass = _passes(et)
    width = et.spec_k + et._n_begin_u
    conj = et.coord_sampler == "conjugate"

    s = ej.init(jax.random.key(3), C)
    rng = np.random.default_rng(5)
    # lanes at different sweep counts, some close to the quota, so that
    # sweeps complete, draws land in their slots and lanes go idle
    sc = jnp.asarray(rng.integers(0, N_SWEEPS, C), jnp.int32)
    draws = jnp.zeros((C, N_SWEEPS, D), jnp.float32)
    nevbuf = jnp.zeros((C, N_SWEEPS), jnp.int32)
    passes = (int(N_SWEEPS * D - np.asarray(sc).min() * D) if conj
              else DOUBLING_PASSES if et.slice_kernel == "doubling"
              else PASSES)
    compared = 0
    phases = set()
    for _ in range(passes):
        r = _jax_draws(ej, s, width)
        st = mt.convert_state(s, et)
        sc_t = torch.tensor(np.asarray(sc))
        dr_t = torch.tensor(np.asarray(draws))
        nb_t = torch.tensor(np.asarray(nevbuf))
        phases.update(st.phase.tolist())
        kw = {k: torch.tensor(v) for k, v in r.items()}
        if conj:
            near = np.zeros(C, bool)
        else:
            f, level, lsum = _f_and_level(et, st, kw["u"])
            near = (np.abs(f - level[:, None])
                    <= LD0_TOL["atol"] + LD0_TOL["rtol"] * np.abs(lsum)
                    ).any(1)

        s2, sc2, draws2, nevbuf2 = jax_pass(
            ej, s, sc, draws, nevbuf, N_SWEEPS, adapt, shrink_only, 1)
        t2, sc2_t, dr2_t, nb2_t = port_pass(
            et, st, sc_t, dr_t, nb_t, N_SWEEPS, adapt, shrink_only, 1, **kw)

        same = np.asarray(sc2) == sc2_t.numpy()
        for field in EXACT_FIELDS:
            if field in et.state_cls._fields:
                same &= (np.asarray(getattr(s2, field))
                         == getattr(t2, field).numpy())
        assert not (~same & ~near).any(), (
            f"decisions differ away from the slice level on lanes "
            f"{np.nonzero(~same & ~near)[0]}")
        ok = same & ~near
        compared += int(ok.sum())
        for field in et.state_cls._fields:
            if field in ("key", "ctr"):
                continue
            got = getattr(t2, field).numpy()[ok]
            want = np.asarray(getattr(s2, field))[ok]
            if field in EXACT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=field)
            else:
                tol = LD0_TOL if field == "ld0" else FLOAT_TOL
                np.testing.assert_allclose(got, want, err_msg=field, **tol)
        np.testing.assert_allclose(dr2_t.numpy()[ok],
                                   np.asarray(draws2)[ok], **FLOAT_TOL)
        np.testing.assert_array_equal(nb2_t.numpy()[ok],
                                      np.asarray(nevbuf2)[ok])
        s, sc, draws, nevbuf = s2, sc2, draws2, nevbuf2

    assert compared >= 0.9 * C * passes, compared
    if name == "doubling_small_w":
        # every phase ran: expansion, proposal, back-test, commit
        assert {0, 1, 2, 3} <= phases, phases
        return
    # the run exercised commits, completed sweeps and idle lanes
    assert int(np.asarray(nevbuf).astype(bool).sum()) > 0
    assert int((np.asarray(sc) >= N_SWEEPS).sum()) > 0
