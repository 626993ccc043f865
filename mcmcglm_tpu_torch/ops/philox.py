"""Philox4x32-10 uniforms, in plain torch.

The port's one random stream for the automaton engines: the counter-based
Philox4x32-10 generator (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011) under the key (seed_lo, seed_hi).

* The fused CGGibbs kernels (the counterpart of ``_uniform`` and the
  per-core PRNG seeding of ``mcmcglm_tpu/ops/pallas_cggibbs.py``) use

      counter = (sweep, j, c, t)

  for draw t of chain c at coordinate j of sweep s.  Draw 0 is the slice
  level, draw 1 the interval position, draw 2 the step-out split, draw
  3 + i shrink iteration i.  Every draw is chain-local, so a chain's
  trajectory depends neither on the chain blocking nor on whether a sweep
  runs as one launch or d.  ``csrc/fused_cggibbs.cu`` computes the same
  function.
* The lockstep engine's slice kernels (:func:`counter_uniforms`, read
  through ``ops/slice_kernels.SliceRNG``) use the same counter, (sweep, j,
  c, t), for draw slot t of chain c at coordinate j of sweep s; a kernel's
  loops read slot base + iteration.
* The free-running passes (:func:`pass_uniforms`) use

      counter = (p_lo, p_hi, c, t)

  for slot t of chain c in the pass with index p (a 64-bit count of the
  passes that consumed randomness).  The uniforms of a pass depend on its
  index only, never on how the passes are grouped into blocks.

The bits-to-uniform map is the JAX package's: the first word shifted right
by 9, times 2^-23, clamped to at least 1e-12, so a uniform lies in
[1e-12, 1 - 2^-23].

The 32 x 32 -> 64-bit products are taken in int64 on 16-bit halves, so
that no intermediate leaves the signed 64-bit range.  A key may be a pair
of ints or an int64 tensor of two words (a state's key on the device).
"""

from __future__ import annotations

import torch

__all__ = ["counter_uniforms", "fold_seed", "key_tensor", "pass_uniforms",
           "philox4x32", "philox_uniform", "split_seed"]

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
    if torch.is_tensor(key):  # (2,) int64 words, read on the device
        k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    else:
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


def fold_seed(seed: int, data: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integer ``data`` (the
    counterpart of ``jax.random.fold_in``): the first two words of
    Philox4x32-10 of the counter (data, 0, 0, 0) under the key of
    ``seed``.  The chain-sharded engines give chain shard s the seed
    ``fold_seed(seed, s)``."""
    w = philox4x32((int(data), 0, 0, 0), split_seed(seed))
    return int(w[0]) | (int(w[1]) << 32)


def philox_uniform(seed: int, sweep: int, j: int, t, n_chains: int,
                   device) -> torch.Tensor:
    """float32 uniforms of draw ``t`` at coordinate ``j`` of sweep
    ``sweep``, one per chain c = 0 .. n_chains - 1: (n_chains,) for an int
    ``t``, (T, n_chains) for a (T,) tensor of draw indices."""
    c = torch.arange(n_chains, dtype=torch.int64, device=device)
    t = torch.as_tensor(t, dtype=torch.int64, device=device)
    w0 = philox4x32((sweep, j, c, t.reshape(-1, 1) if t.dim() else t),
                    split_seed(seed))[0]
    return _to_uniform(w0)


def _to_uniform(w0):
    u = (w0 >> 9).to(torch.float32) * (1.0 / (1 << 23))
    return torch.clamp(u, min=1e-12)


def counter_uniforms(key: torch.Tensor, sweep: int, j, n_chains: int,
                     t, chain0: int = 0) -> torch.Tensor:
    """float32 uniforms of counter (sweep, j, c, t) under the (2,) int64
    ``key``, for chains c = chain0 .. chain0 + n_chains - 1, on the key's
    device.  ``j`` is an int or a (J,) tensor of coordinates (a leading J
    axis), ``t`` an int slot or a (W,) tensor of slots (a trailing W axis):
    the result is (C,), (C, W), (J, C) or (J, C, W)."""
    dev = key.device
    jj = torch.as_tensor(j, dtype=torch.int64, device=dev)
    tt = torch.as_tensor(t, dtype=torch.int64, device=dev)
    c = torch.arange(chain0, chain0 + n_chains, dtype=torch.int64,
                     device=dev)
    w0 = philox4x32((sweep, jj.reshape(-1, 1, 1), c.reshape(1, -1, 1),
                     tt.reshape(1, 1, -1)), key)[0]
    u = _to_uniform(w0)
    if jj.dim() == 0:
        u = u[0]
    return u[..., 0] if tt.dim() == 0 else u


def key_tensor(seed: int, device) -> torch.Tensor:
    """The Philox key of ``seed`` as an int64 (2,) tensor on ``device``."""
    return torch.tensor(split_seed(seed), dtype=torch.int64, device=device)


def pass_uniforms(key: torch.Tensor, p0: torch.Tensor, n_passes: int,
                  n_chains: int, width: int) -> torch.Tensor:
    """float32 uniforms (n_passes, n_chains, width) of the passes with
    indices p0, p0 + 1, ..., under the (2,) int64 ``key``; ``p0`` is a 0-d
    int64 tensor.  Row i is the block of pass p0 + i.  Computed on the
    key's device without reading it on the host, so a CUDA graph can
    capture it."""
    dev = key.device
    p = p0 + torch.arange(n_passes, dtype=torch.int64, device=dev)
    c = torch.arange(n_chains, dtype=torch.int64, device=dev)
    t = torch.arange(width, dtype=torch.int64, device=dev)
    w0 = philox4x32((p[:, None, None] & _MASK32, p[:, None, None] >> 32,
                     c[None, :, None], t[None, None, :]), key)[0]
    return _to_uniform(w0)
