"""Philox4x32-10 uniforms for the fused CGGibbs kernels, in plain torch.

Counterpart of ``_uniform`` and the per-core PRNG seeding of
``mcmcglm_tpu/ops/pallas_cggibbs.py``.  The TPU kernels draw from the
core's hardware generator, reseeded per (sweep, chain block, coordinate);
the port uses the counter-based Philox4x32-10 generator (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011) with

    counter = (sweep, j, c, t),    key = (seed_lo, seed_hi)

for draw t of chain c at coordinate j of sweep s.  Draw 0 is the slice
level, draw 1 the interval position, draw 2 the step-out split, draw 3 + i
shrink iteration i.  Every draw is chain-local, so a chain's trajectory
depends neither on the chain blocking nor on whether a sweep runs as one
launch or d.  ``csrc/fused_cggibbs.cu`` computes the same function; the
bits-to-uniform map is the JAX package's: the first word shifted right by
9, times 2^-23, clamped to at least 1e-12.

The 32 x 32 -> 64-bit products are taken in int64 on 16-bit halves, so
that no intermediate leaves the signed 64-bit range.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "philox_uniform", "split_seed"]

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b, b in [0, 2^32)."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    """Philox4x32-``rounds`` of a counter of four 32-bit words (ints or
    broadcastable int64 tensors) under a key of two; returns the four
    output words as int64 tensors holding uint32 values."""
    device = next((v.device for v in counter if torch.is_tensor(v)), None)
    c = torch.broadcast_tensors(*[
        torch.as_tensor(v, dtype=torch.int64, device=device) for v in counter
    ])
    c0, c1, c2, c3 = (v & _MASK32 for v in c)
    k0, k1 = (int(k) & _MASK32 for k in key)
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_seed(seed: int):
    """The Philox key (seed_lo, seed_hi) of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def philox_uniform(seed: int, sweep: int, j: int, t, n_chains: int,
                   device) -> torch.Tensor:
    """float32 uniforms of draw ``t`` at coordinate ``j`` of sweep
    ``sweep``, one per chain c = 0 .. n_chains - 1: (n_chains,) for an int
    ``t``, (T, n_chains) for a (T,) tensor of draw indices."""
    c = torch.arange(n_chains, dtype=torch.int64, device=device)
    t = torch.as_tensor(t, dtype=torch.int64, device=device)
    w0 = philox4x32((sweep, j, c, t.reshape(-1, 1) if t.dim() else t),
                    split_seed(seed))[0]
    u = (w0 >> 9).to(torch.float32) * (1.0 / (1 << 23))
    return torch.clamp(u, min=1e-12)
