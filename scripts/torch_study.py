"""What the port's study scripts (``scripts/torch_*.py``) share: the device
check, the card's nvidia-smi line, timing in windows, and the JSONL
records they print and write.

A study script defaults to ``--device cuda`` and raises without CUDA; only
``--device cpu`` runs on the CPU.  On the card its rows go to a new
``results/torch_<name>_h100.jsonl`` (``--out`` names another file), each
row carrying the card's ``nvidia-smi --query-gpu=name,power.limit`` line;
on the CPU the rows are printed only, unless ``--out`` is given.
"""

import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# timed windows per measurement: the host clock spreads by about 20% over
# short runs, so rows report the median of three
REPEATS = 3


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    return dev


def card_line(device: torch.device) -> str:
    """The card's "name, power limit" as nvidia-smi gives them; "cpu" for
    the CPU."""
    if device.type != "cuda":
        return "cpu"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def card_clocks(device: torch.device) -> str:
    """The card's SM and memory clocks, power draw and temperature as
    nvidia-smi reads them now; "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_windows(step, n_windows: int, device: torch.device) -> list:
    """Seconds of each of ``n_windows`` calls of ``step()`` (host clock,
    synchronised before and after each)."""
    out = []
    for _ in range(n_windows):
        sync(device)
        t0 = time.perf_counter()
        step()
        sync(device)
        out.append(time.perf_counter() - t0)
    return out


class Records:
    """JSONL rows: printed, and written to ``path`` (a new file) when one
    is given; every row gets ``device`` and ``card``."""

    def __init__(self, name: str, device: torch.device, out=None):
        self.device = device
        self.card = card_line(device)
        if out is None and device.type == "cuda":
            out = os.path.join(REPO, "results", f"torch_{name}_h100.jsonl")
        self.path = out
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            open(out, "w").close()

    def write(self, row: dict) -> dict:
        row = {**row, "device": str(self.device), "card": self.card}
        line = json.dumps(row, default=_plain)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(line + "\n")
        return row


def _plain(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"not JSON serialisable: {type(v)}")


def measure_freerun(eng, n_chains: int, warmup: int, timed: int,
                    seed: int = 0) -> dict:
    """The free-running study protocol on ``eng``: init ``n_chains`` chains
    from ``seed``, ``warmup`` adaptive sweeps, one untimed sweep (its
    sampling graphs are captured there), then ``timed`` sweeps in
    ``REPEATS`` equal windows.  Rates are the median window's; the ESS is
    ``diagnostics.ess`` of all timed draws, on the host, outside the
    windows, over the windows' total seconds."""
    from mcmcglm_tpu_torch.diagnostics import ess

    device = eng.device
    state = eng.init(seed, n_chains)
    state, _, _ = eng.warmup(state, warmup)
    state, _, _ = eng.run(state, 1)
    nev0, ctr0 = state.nev.double().clone(), int(state.ctr)
    per_window = max(1, timed // REPEATS)
    parts = []

    def window():
        nonlocal state
        state, draws, _ = eng.run(state, per_window)
        parts.append(draws)

    secs = timed_windows(window, REPEATS, device)
    draws = np.concatenate([p.cpu().numpy() for p in parts], axis=1)
    n_timed = draws.shape[1]
    med, total = float(np.median(secs)), float(np.sum(secs))
    passes = int(state.ctr) - ctr0
    e = ess(draws)
    return {
        "chains": n_chains, "warmup": warmup, "timed_sweeps": n_timed,
        "window_seconds": secs,
        "sweeps_per_s": per_window / med,
        "chain_sweeps_per_s": n_chains * per_window / med,
        "evals_per_coord": float((state.nev.double() - nev0).mean())
        / n_timed / eng.d,
        "passes_per_sweep": passes / n_timed,
        "ms_per_pass": 1e3 * total / passes,
        "min_ess": float(np.min(e)),
        "median_ess": float(np.median(e)),
        "min_ess_per_s": float(np.min(e)) / total,
        "min_ess_per_draw": float(np.min(e)) / (n_chains * n_timed),
    }
