"""The least-time bounds that ``chip_smoke.py`` writes into its per-kernel
record, checked on the CPU against numbers worked out by hand: bytes
counted once (each distinct X^T row once), evaluations counted over
observations of nonzero weight, 39 instructions per binomial evaluation
in a battery (predictor 2, density 34, masked sum 3) and 12 per gaussian
evaluation in a fused kernel (2 + 8 + 2)."""

import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

HBM = 3.35e12  # bytes/s
ISSUE = 33.5e12  # float32 instructions/s: 67 TFLOP/s, an FMA as two


def test_bound_is_the_larger_of_bytes_and_instructions():
    assert smoke.bound(HBM, 0) == (1e3, "bytes")
    ms, by = smoke.bound(1.0, 2 * ISSUE)
    assert (ms, by) == (2e3, "operations")


# C=4 chains, n=8 observations (one of zero weight), K=2 proposals:
# eta 128 B (and eta_new 128 B with a commit), y and m 64 B, deltas and
# lsum 64 B (and fprior 32 B and scal 64 B with a commit); the rows are
# 4 x 8 floats, 128 B, or for the gather the 2 distinct rows of j, 64 B,
# and j, 16 B.  56 evaluations x 39 instructions = 2,184, 0.65e-10 s: the
# bytes bound.
@pytest.mark.parametrize("kernel,nbytes", [("battery_sums", 384),
                                           ("battery_commit", 608),
                                           ("battery_gather_commit", 560)])
def test_battery_bound_counts_bytes_once(kernel, nbytes):
    C, n, K = 4, 8, 2
    m = torch.ones(n)
    m[3] = 0.0  # a zero weight: no evaluation there
    a = dict(eta=torch.zeros(C, n), m=m,
             j=torch.tensor([1, 1, 2, 1], dtype=torch.int32))
    ms, by = smoke.battery_bound(a, K, "binomial", kernel)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / HBM)


def test_gather_bound_at_the_main_shape_is_instruction_bound():
    # C=256, n=10,000, K=4: 10.24 M evaluations x 39 = 399.36 M
    # instructions, 11.92 us; the bytes (eta in and out 20.48 MB, 200
    # distinct rows 8 MB) need 8.5 us
    C, n, K = 256, 10_000, 4
    a = dict(eta=torch.zeros(C, n), m=torch.ones(n),
             j=(torch.arange(C) % 200).to(torch.int32))
    ms, by = smoke.battery_bound(a, K, "binomial", "battery_gather_commit")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 399_360_000 / ISSUE)
    assert ms == pytest.approx(0.0119212, rel=1e-5)


def test_fused_bound_counts_the_ld0_pass_and_the_update():
    # gaussian, C=8, n=100, d=3, 7 counted evaluations per chain: 56 x 100
    # x 12 = 67,200 instructions, and the cache and update of 3
    # coordinates 8 x 3 x 100 x 10 = 24,000; 91,200 in all, 2.72 ns,
    # against 8,224 bytes, 2.45 ns
    C, n, d = 8, 100, 3
    nev = torch.full((C,), 7, dtype=torch.int32)
    ms, by = smoke.fused_bound(nev, C, n, d, "gaussian")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 91_200 / ISSUE)
