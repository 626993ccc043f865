"""The frozen yardstick against the program it copies: the ESS, the data,
the roofline counts; and the card-only pieces, which skip here.

    python -m pytest benchmark/tests -q
"""

import json
import sys

import numpy as np
import pytest
import torch

from benchtools import BENCH, REPO

sys.path[:0] = [str(REPO)]

from benchmark import check, datagen, ess, roofline  # noqa: E402


def _ar1(C, S, d, rho, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((C, S, d))
    x[:, 0] = rng.normal(size=(C, d))
    for s in range(1, S):
        x[:, s] = rho * x[:, s - 1] + np.sqrt(1 - rho ** 2) * rng.normal(
            size=(C, d))
    return x + rng.normal(size=d) * 0.1


@pytest.mark.parametrize("shape,rho", [((4, 200, 3), 0.5), ((16, 61, 5), 0.9),
                                       ((2, 9, 2), 0.0), ((8, 40, 4), -0.3)])
def test_ess_matches_the_port(shape, rho):
    from mcmcglm_tpu_torch.diagnostics import ess as port_ess

    x = _ar1(*shape, rho, seed=shape[1])
    want = port_ess(x, use_native=False, rank_normalized=True)
    got_np = [ess.ess_numpy(x[:, :, j]) for j in range(shape[2])]
    got_t = ess.ess_torch(torch.as_tensor(x), block=2)
    np.testing.assert_allclose(got_np, want, rtol=1e-10)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-9)


@pytest.mark.parametrize("config", ["logistic_p1000", "poisson_laplace_p100"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_datagen_matches_the_port(config, seed):
    """Each configuration's data, its response law from its reference
    file, as the port's generator makes it."""
    from mcmcglm_tpu_torch.datagen import generate_glm_data

    from benchmark import spec

    config = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    X, y, b = datagen.glm_data(spec.Model(config).sample, 50, 7, seed)
    X0, y0, b0 = generate_glm_data(config["family"], 50, 7, seed=seed)
    np.testing.assert_array_equal(X, X0)
    np.testing.assert_array_equal(y, y0)
    np.testing.assert_array_equal(b, b0)


def test_battery_bound_at_the_bench_shape():
    """PERF.md's kernel table: 11.92 us, bound by instructions."""
    t, by = roofline.battery_bound(256, 10_000, 4, "binomial/logit",
                                   "battery_gather_commit", rows=256)
    assert by == "operations"
    assert round(1e6 * t, 2) == 11.92


def test_counts_copied_from_the_smoke():
    src = (REPO / "chip_smoke.py").read_text()
    assert 'DENSITY_INSTR = {"binomial": 34, "gaussian": 8}' in src
    assert roofline.DENSITY_INSTR["binomial/logit"] == 34
    assert roofline.DENSITY_INSTR["gaussian/identity"] == 8
    for name in ("ETA_INSTR", "BATTERY_SUM_INSTR", "FUSED_SUM_INSTR"):
        assert f"{name} = {getattr(roofline, name)} " in src


def test_fused_bound_and_sweep_count():
    t, by = roofline.fused_bound(256 * 3_300, 256, 10_000, 1_000,
                                 "binomial/logit")
    assert by == "operations"
    per_eval = 2 + 34 + 2
    want = (256 * 3_300 * 10_000 * per_eval + 256 * 1_000 * 10_000 * 36)
    assert t == pytest.approx(want / roofline.F32_INSTR_PER_S)
    assert roofline.sweep_instructions(10, 2, 5, 3, "poisson/log") == (
        10 * 5 * (2 + 10 + 3) + 2 * 3 * 5 * 2)
    assert roofline.sweep_instructions(10, 2, 5, 3, "Gamma/inverse") is None


def test_ks_and_pit_on_exact_draws():
    """Draws made exactly from each conditional (by inverting the
    reference's own CDF) give uniform transforms; shifted draws do not."""
    from benchmark import spec

    config = json.loads((BENCH / "configs" / "logistic_p1000.json")
                        .read_text())
    model = spec.Model(config)
    X, y, beta = datagen.glm_data(model.sample, 400, 3, 11)
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    rng = np.random.default_rng(5)
    C, S = 64, 6
    draws = torch.as_tensor(np.tile(beta, (C, S, 1)))
    idx = torch.as_tensor(np.stack([np.arange(C), np.full(C, 1),
                                    rng.integers(0, 3, C)], 1))
    u = torch.as_tensor(rng.random(C))
    exact = check.control_draws(model, X, y, draws, idx, u,
                                dtype=torch.float64)
    p = check.pit(model, X, y, draws, idx, new=exact).numpy()
    np.testing.assert_allclose(p, u.numpy(), atol=5e-3)
    assert check.ks_uniform(p) < 0.2
    assert check.ks_uniform(np.clip(p + 0.3, 0, 1)) > 0.25


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_canary_reads_a_latency(card):
    """A reading is a plausible latency, and the graph adds into the
    element the canary holds, never into memory handed to another tensor:
    after the eager warm-up, the upload and two readings it holds every
    addition."""
    from benchmark import canary

    c = canary.Canary(card)
    others = [torch.zeros(1, device=card) for _ in range(64)]
    us = c.read()
    assert 0.3 < us < 20.0
    c.read()
    assert float(c.x) == canary.KERNELS * (1 + 3 * canary.REPLAYS)
    assert all(float(t) == 0.0 for t in others)
