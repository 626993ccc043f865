"""The port's multi-card engines on the CPU: spawned "gloo" worlds of two
and four processes against the JAX package's sharded engines on the
conftest's virtual CPU devices, and against the port's own invariants.

Each world is spawned once per module (``parallel.launch.run_local``)
and runs every check of its mesh shapes in its ranks
(tests/torch_dist_cases.py); the tests read its results.

* In law: ShardedFreeRunCGGibbs on (2, 1) and ObsShardedFreeRunCGGibbs
  on (1, 2) and (2, 2) against the JAX engines on the same mesh shapes:
  posterior means within 4 Monte Carlo standard errors, evaluations per
  coordinate within 3 standard errors.
* One pass: from the same JAX sharded state (``convert_sharded_state``)
  and the same uniforms, the all-reduced battery sums to rtol 1e-5 and
  the committed state where no decision flips (integer registers and
  decisions exactly, floats to the one-pass tolerance of
  tests/test_torch_pass.py: JAX's and torch's transcendentals differ by
  ulps).
* Invariants: a chain shard is bitwise a standalone engine; the chain
  path makes no collective and the obs path one all-reduce per pass; the
  obs ranks of a chain row agree bitwise; (S, 1) obs-sharded is bitwise
  chain-sharded; ShardedCGGibbs on (S, 1) is bitwise CGGibbs;
  ``run_passes`` is bitwise ``run``; padding does not bias; the
  validation errors and the ``mcmcglm(mesh=)`` routes; the four-card
  check (scripts/torch_multicard_check.py) on four CPU ranks.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402
from mcmcglm_tpu.ops import freerun_passes as jp  # noqa: E402
from mcmcglm_tpu.parallel import (  # noqa: E402
    ObsShardedFreeRunCGGibbs as JaxObs,
    ShardedFreeRunCGGibbs as JaxChain,
    make_mesh as jax_mesh,
)

import mcmcglm_tpu_torch as mt  # noqa: E402
import torch_dist_cases as cases  # noqa: E402
from mcmcglm_tpu_torch.ops.philox import fold_seed  # noqa: E402
from mcmcglm_tpu_torch.ops.slice_kernels import SliceRNG  # noqa: E402
from mcmcglm_tpu_torch.parallel.launch import run_local  # noqa: E402

INT_FIELDS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_pass.py
LD0_TOL = dict(rtol=2e-5, atol=2e-3)
SUM_RTOL = 1e-5
PASSES, PASS_C = 8, 16
SPAWN_TIMEOUT = 240.0


def _mesh(*shape):
    n = int(np.prod(shape))
    return jax_mesh(*shape, devices=jax.devices()[:n])


def _jax_law(eng, key, C, warm=30, sweeps=120):
    s = eng.init(jax.random.key(key), C)
    s, _, _ = eng.warmup(s, warm)
    nev0 = np.asarray(s.nev).copy()
    s, draws, _ = eng.run(s, sweeps)
    d = np.asarray(draws).shape[-1]
    return np.asarray(draws), (np.asarray(s.nev) - nev0) / (sweeps * d)


def _jax_passes(eng_j, ej, S):
    """PASSES passes of the JAX package from a sharded engine's state after
    2 warmup sweeps, each chain shard under its own key: for each pass the
    state (numpy, global), the shards' uniforms and the JAX result."""
    s = eng_j.init(jax.random.key(3), PASS_C)
    s, _, _ = eng_j.warmup(s, 2)
    c = PASS_C // S
    keys = [s.key[i] for i in range(S)]
    arr = {k: np.asarray(getattr(s, k)) for k in s._fields if k != "key"}
    rng = np.random.default_rng(5)
    sc = rng.integers(0, cases.PASS_SWEEPS, PASS_C).astype(np.int32)
    draws = np.zeros((PASS_C, cases.PASS_SWEEPS, ej.d), np.float32)
    nevbuf = np.zeros((PASS_C, cases.PASS_SWEEPS), np.int32)
    width = ej.spec_k + ej._n_begin_u
    step_fn = jax.jit(lambda st, sc_, dr, nb: jp.run_pass_spec(
        ej, st, sc_, dr, nb, cases.PASS_SWEEPS, True, False, None))
    steps = []
    for _ in range(PASSES):
        us, outs = [], []
        for sh in range(S):
            rows = slice(sh * c, (sh + 1) * c)
            st = type(s)(**{k: jnp.asarray(v[rows]) for k, v in arr.items()},
                         key=keys[sh])
            _, k_u = jax.random.split(keys[sh])
            us.append(np.asarray(jax.random.uniform(k_u, (c, width),
                                                    jnp.float32)))
            outs.append(step_fn(st, jnp.asarray(sc[rows]),
                                jnp.asarray(draws[rows]),
                                jnp.asarray(nevbuf[rows])))
        want = dict(
            state={k: np.concatenate([np.asarray(getattr(o[0], k))
                                      for o in outs]) for k in arr},
            sc=np.concatenate([np.asarray(o[1]) for o in outs]),
            draws=np.concatenate([np.asarray(o[2]) for o in outs]),
            nevbuf=np.concatenate([np.asarray(o[3]) for o in outs]))
        steps.append(dict(state=types.SimpleNamespace(**arr), u=np.stack(us),
                          sc=sc, draws=draws, nevbuf=nevbuf, want=want))
        keys = [o[0].key for o in outs]
        arr, sc = want["state"], want["sc"]
        draws, nevbuf = want["draws"], want["nevbuf"]
    return steps


@pytest.fixture(scope="module")
def jax_side():
    X, y = cases.gaussian_problem()
    d = X.shape[1]
    prior = mg.IIDPrior(mg.Normal(0.0, 1.0), d)
    kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5}, spec_k=4)
    Xb, yb, _ = mg.generate_glm_data("binomial", n=400, d=6, seed=5)
    chain = JaxChain(Xb, yb, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 6),
                     mesh=_mesh(2, 1), tuning=cases.QUANTILE,
                     slice_kernel="quantile", spec_k=4)
    Xp, yp, _ = mg.generate_glm_data("binomial", n=300, d=3, seed=4)
    pkw = dict(tuning=cases.QUANTILE, slice_kernel="quantile", spec_k=4)
    pprior = mg.IIDPrior(mg.Normal(0.0, 1.0), 3)
    ej = JaxFreeRun(Xp, yp, "binomial", pprior, **pkw)
    assert ej.battery_impl == "xla" and ej.eval_cache == "scalar"
    return dict(
        law_chain=_jax_law(chain, 1, 16),
        law_obs12=_jax_law(JaxObs(X, y, "gaussian", prior, mesh=_mesh(1, 2),
                                  **kw), 1, 8),
        law_obs22=_jax_law(JaxObs(X, y, "gaussian", prior, mesh=_mesh(2, 2),
                                  **kw), 2, 8),
        inputs=dict(
            binomial=(Xb, yb), pass_problem=(Xp, yp),
            pass_chain=_jax_passes(JaxChain(Xp, yp, "binomial", pprior,
                                            mesh=_mesh(2, 1), **pkw), ej, 2),
            pass_obs=_jax_passes(JaxObs(Xp, yp, "binomial", pprior,
                                        mesh=_mesh(1, 2), **pkw), ej, 1)),
        ej=ej,
    )


@pytest.fixture(scope="module")
def world2(jax_side):
    inputs = {k: ([dict(s, want=None) for s in v]
                  if k in ("pass_chain", "pass_obs") else v)
              for k, v in jax_side["inputs"].items()}
    return run_local(cases.world2, 2, (inputs,), device_type="cpu",
                     timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world4():
    return run_local(cases.world4, 4, device_type="cpu", timeout=SPAWN_TIMEOUT)


def _agree_in_law(port, jax_, d):
    (dp, rp), (dj, rj) = port, jax_
    pm, jm = dp.reshape(-1, d), dj.reshape(-1, d)
    se = np.sqrt(pm.var(0) / mt.ess(dp) + jm.var(0) / mt.ess(dj))
    assert (np.abs(pm.mean(0) - jm.mean(0)) < 4 * se).all(), (
        pm.mean(0), jm.mean(0), se)
    se_r = np.sqrt(rp.var(ddof=1) / rp.size + rj.var(ddof=1) / rj.size)
    assert abs(rp.mean() - rj.mean()) < 3 * se_r, (rp.mean(), rj.mean(),
                                                   se_r)


# -- in law against the JAX package -------------------------------------------


def test_chain_sharded_matches_jax_in_law(world2, jax_side):
    _agree_in_law(world2[0]["law_chain"], jax_side["law_chain"], 6)
    for r in world2:  # every rank returns all chains
        np.testing.assert_array_equal(r["law_chain"][0],
                                      world2[0]["law_chain"][0])


def test_obs_sharded_12_matches_jax_in_law(world2, jax_side):
    _agree_in_law(world2[0]["law_obs12"], jax_side["law_obs12"], 5)


def test_obs_sharded_22_matches_jax_in_law(world4, jax_side):
    _agree_in_law(world4[0]["law"], jax_side["law_obs22"], 5)


def test_obs_padding_does_not_bias(world2, world4):
    """n = 203 pads one row on two obs shards (the (1, 2) and (2, 2)
    meshes); the posterior mean stays the conjugate one."""
    X, y = cases.gaussian_problem()
    d = X.shape[1]
    prec = X.T @ X + np.eye(d)
    mu = np.linalg.solve(prec, X.T @ y)
    assert world2[0]["obs12_n_local"] == 102 and world4[0]["n_local"] == 102
    for draws in (world2[0]["law_obs12"][0], world4[0]["law"][0],
                  world2[0]["lockstep12"][:, 10:]):
        post = draws.reshape(-1, d)
        se = np.sqrt(post.var(0) / mt.ess(draws))
        assert (np.abs(post.mean(0) - mu) < 4 * se + 1e-3).all(), (
            post.mean(0), mu)


# -- one pass from the same JAX state -----------------------------------------


@pytest.mark.parametrize("name", ["pass_chain", "pass_obs"])
def test_one_pass_matches_jax(world2, jax_side, name):
    ej = jax_side["ej"]
    steps = jax_side["inputs"][name]
    obs = name == "pass_obs"
    C = PASS_C
    compared = 0
    for i, step in enumerate(steps):
        want = step["want"]
        got = [r[name][i] for r in world2]
        if obs:  # the obs ranks agree bitwise on everything replicated
            for k, v in got[0]["state"].items():
                if k != "eta":
                    np.testing.assert_array_equal(v, got[1]["state"][k], k)
            np.testing.assert_array_equal(got[0]["lsum"], got[1]["lsum"])
            state = dict(got[0]["state"], eta=np.concatenate(
                [g["state"]["eta"] for g in got], 1))
            g = dict(got[0], state=state)
        else:  # each rank holds its chain shard's rows
            g = {k: np.concatenate([r[k] for r in got])
                 for k in ("sc", "draws", "nevbuf", "lsum", "deltas", "f",
                           "level")}
            g["state"] = {k: np.concatenate([r["state"][k] for r in got])
                          for k in got[0]["state"] if k not in ("key", "ctr")}
        # the all-reduced sums against the JAX package's sums over all n
        s0 = step["state"]
        xg = np.asarray(ej.Xt)[s0.j]
        e = (s0.eta[:, None, :] + xg[:, None, :] * g["deltas"][:, :, None])
        lsum_j = np.asarray(ej.reduce_fn(ej._ld_eta(
            jnp.asarray(e, jnp.float32), ej.y, ej.extra)))
        np.testing.assert_allclose(g["lsum"], lsum_j, rtol=SUM_RTOL)
        near = (np.abs(g["f"] - g["level"][:, None])
                <= LD0_TOL["atol"] + LD0_TOL["rtol"] * np.abs(g["lsum"])
                ).any(1)
        same = g["sc"] == want["sc"]
        for k in INT_FIELDS:
            same &= g["state"][k] == want["state"][k]
        assert not (~same & ~near).any(), np.nonzero(~same & ~near)
        ok = same & ~near
        compared += int(ok.sum())
        for k, v in want["state"].items():
            if k in INT_FIELDS:
                np.testing.assert_array_equal(g["state"][k][ok], v[ok], k)
            else:
                tol = LD0_TOL if k == "ld0" else FLOAT_TOL
                np.testing.assert_allclose(g["state"][k][ok], v[ok],
                                           err_msg=k, **tol)
        np.testing.assert_allclose(g["draws"][ok], want["draws"][ok],
                                   **FLOAT_TOL)
        np.testing.assert_array_equal(g["nevbuf"][ok], want["nevbuf"][ok])
    assert compared >= 0.9 * C * PASSES


# -- the port's own invariants ------------------------------------------------


def test_chain_shard_is_bitwise_standalone(world2):
    assert all(r["chain_standalone"] for r in world2)


def test_chain_path_makes_no_collective(world2):
    assert all(r["chain_collectives"] == {} for r in world2)


def test_obs_path_makes_one_all_reduce_per_pass(world2, world4):
    for r in world2:
        calls, passes = r["obs12_allreduce"]
        assert calls == passes > 100
        assert set(r["obs12_other_collectives"]) <= {"all_gather"}
    for r in world4:
        calls, passes = r["allreduce"]
        assert calls == passes > 100


def test_obs_ranks_agree_bitwise(world2, world4):
    """The obs ranks of one chain row hold the same beta, registers,
    caches and counters, bit for bit, after the run (ranks 0-1 of the
    (1, 2) mesh; 0-1 and 2-3 of the (2, 2) mesh)."""
    rows = [[r["obs12_state"] for r in world2],
            [r["state"] for r in world4[:2]], [r["state"] for r in world4[2:]]]
    for a, b in rows:
        for k, v in a.items():
            if k != "eta":
                np.testing.assert_array_equal(v, b[k], k)
    assert not np.array_equal(rows[1][0]["beta"], rows[2][0]["beta"])


def test_obs_eta_stays_x_beta(world2):
    assert all(r["obs12_eta_drift"] < 1e-4 for r in world2)


def test_obs_mesh_with_one_obs_shard_is_bitwise_chain_sharded(world2):
    assert all(r["obs21_bitwise"] for r in world2)
    assert world2[0]["obs21_loop"] == "eager: CPU tensors"


def test_sharded_lockstep_on_chain_mesh_is_bitwise_cggibbs(world2):
    assert all(r["lockstep21_bitwise"] for r in world2)


def test_run_passes_is_bitwise_run_on_the_sharded_engines(world2):
    assert all(r["chain_run_passes"] and r["chain_warmup_passes"]
               and r["obs12_run_passes"] for r in world2)


def test_pooled_summary_merges_the_ranks(world2):
    r = world2[0]
    np.testing.assert_allclose(r["pooled_mean"], r["all_means"].mean(0),
                               rtol=1e-6)
    np.testing.assert_array_equal(world2[1]["pooled_ess"], r["pooled_ess"])
    assert np.isfinite(r["pooled_ess"]).all() and r["all_kept"].shape[0] == 8


@pytest.mark.parametrize("name", [
    "chain_obs_mesh", "chain_divisible", "obs_commit_battery",
    "obs_reduce_fn", "obs_weights_length", "obs_scalar_extra",
    "obs_divisible", "obs_graph_cpu", "lockstep_divisible",
    "lockstep_weights", "fused_mesh", "mesh_shape", "mesh_obs_divisible",
])
def test_validation_errors(world2, name):
    ok, msg = world2[0]["errors"][name]
    assert ok, msg


def test_api_mesh_routes(world2):
    X, y = cases.gaussian_problem()
    d = X.shape[1]
    mu = np.linalg.solve(X.T @ X + np.eye(d), X.T @ y)
    routes = world2[0]["routes"]
    assert routes["chain"][0] == "ShardedFreeRunCGGibbs"
    assert routes["obs"][0] == "ObsShardedFreeRunCGGibbs"
    assert routes["lockstep"][0] == "ShardedCGGibbs"
    assert routes["thinned"][0] == "ShardedFreeRunCGGibbs"
    for name, (_, shape, mean) in routes.items():
        assert shape[0] == 8, name  # every chain, on every rank
        assert np.abs(mean - mu).max() < 0.15, (name, mean, mu)
    for name in routes:
        np.testing.assert_array_equal(world2[1]["routes"][name][2],
                                      routes[name][2])


# -- single-process pieces ----------------------------------------------------


def test_slice_rng_chain_offsets_tile_the_unsharded_stream():
    key = torch.tensor([7, 11], dtype=torch.int64)
    whole = SliceRNG(key, (2, 5), 8).uniforms(3, 40)
    parts = [SliceRNG(key, (2, 5), 4, chain0=c0).uniforms(3, 40)
             for c0 in (0, 4)]
    assert torch.equal(torch.cat(parts), whole)
    tab = SliceRNG(key, (2, 5), 4, chain0=4).shifted(1).uniforms(2, 3)
    assert torch.equal(tab, whole[4:, 0:3])  # slots 3 .. 5


def test_shard_seeds_differ_and_repeat():
    seeds = [fold_seed(3, s) for s in range(4)]
    assert len(set(seeds)) == 4 and seeds == [fold_seed(3, s)
                                              for s in range(4)]
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_multicard_check_rehearses_on_four_cpu_ranks():
    """scripts/torch_multicard_check.py, the four-card NCCL check, on four
    CPU ranks over gloo: chain shards bitwise standalone, the obs mesh's
    loops bitwise equal and its ranks in agreement, and the pooled
    monitor's merged summaries within their tolerances of the float64
    reference, the bfloat16 fold outside them."""
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_multicard_check.py")
    out = subprocess.run([sys.executable, script, "--cpu", "4"],
                         capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTICARD_OK" in out.stdout
    assert out.stdout.count("bitwise standalone True") == 4
    assert "): within; bfloat16 moments" in out.stdout
