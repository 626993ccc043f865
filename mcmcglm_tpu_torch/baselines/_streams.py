"""The chain-local random streams of the baseline samplers.

Slot t of site s at step k of chain c is Philox4x32-10 (``ops/philox.py``)
of the counter (k, s, c, t) under the key of the sampler's integer seed,
c the chain's row.  The first two output words give a 52-bit uniform,
(m + 1/2) 2^-52, strictly inside (0, 1) and exact in float64; normals are ``ndtri`` of it and exponentials ``-log``
of it, both taken in float64 and rounded once to the sampler's dtype.
The samplers draw tables of up to 64 steps at once (:meth:`Streams.steps`),
every slot of a site, so a chain's draws depend neither on the number of
chains nor on when they are read.  Each module's docstring lists its
sites and slots.  An initial prior draw (:func:`prior_draws`) comes from
the prior's own sampler under a CPU ``torch.Generator`` seeded with
``fold_seed(seed, c)`` for chain c.

A :class:`Streams` also carries the masked loops' settings that
``ops/slice_kernels.masked_loop`` reads: ``block``, the iterations per
host read of a loop's flag, and ``stats["flag_reads"]``.
"""

from __future__ import annotations

import torch

from ..ops.philox import fold_seed, key_tensor, philox4x32
from ..ops.slice_kernels import _BLOCK_ITERS

__all__ = ["Streams", "prior_draws"]

_TWO_M52 = 2.0 ** -52
# steps per Philox table (a table costs one Philox evaluation, a few
# hundred small operations, whatever its size)
_TABLE_STEPS = 64


class Streams:
    """The Philox streams of ``n_chains`` chains under ``key``: an integer
    seed or a state's (2,) int64 key tensor."""

    def __init__(self, key, n_chains: int, *, dtype, device,
                 block: int = _BLOCK_ITERS):
        self.key = (key.to(device) if torch.is_tensor(key)
                    else key_tensor(int(key), device))
        self.dtype = dtype
        self.device = torch.device(device)
        self.block = int(block)
        self.stats = {"flag_reads": 0}
        self.chains = torch.arange(int(n_chains), dtype=torch.int64,
                                   device=self.device)

    def uniforms64(self, steps, sites):
        """float64 uniforms of the (site, n_slots) pairs in ``sites`` at the
        steps ``steps`` (a range or a sequence of ints): one (S, C, n_slots)
        tensor per site, from one Philox call."""
        dev = self.device
        st = torch.as_tensor(list(steps), dtype=torch.int64, device=dev)
        s = torch.cat([torch.full((n,), site, dtype=torch.int64, device=dev)
                       for site, n in sites])
        t = torch.cat([torch.arange(n, dtype=torch.int64, device=dev)
                       for _, n in sites])
        w = philox4x32((st[:, None, None], s[None, None, :],
                        self.chains[None, :, None], t[None, None, :]),
                       self.key)
        m = (w[0] >> 6) * (1 << 26) + (w[1] >> 6)  # < 2^52
        u = (m.to(torch.float64) + 0.5) * _TWO_M52
        return list(torch.split(u, [n for _, n in sites], dim=-1))

    def steps(self, start: int, n: int, sites):
        """Yields (k, [(C, n_slots) float64 uniforms per site]) for the
        steps k = start .. start + n - 1, drawn in tables of
        ``_TABLE_STEPS`` steps."""
        for k0 in range(start, start + n, _TABLE_STEPS):
            tabs = self.uniforms64(range(k0, min(k0 + _TABLE_STEPS,
                                                 start + n)), sites)
            for i in range(tabs[0].shape[0]):
                yield k0 + i, [t[i] for t in tabs]

    def uniform(self, u64):
        return u64.to(self.dtype)

    def normal(self, u64):
        return torch.special.ndtri(u64).to(self.dtype)

    def exponential(self, u64):
        return (-torch.log(u64)).to(self.dtype)


def prior_draws(prior, seed: int, n_chains: int, *, dtype, device):
    """(C, d) prior draws: chain c's from ``prior.sample_beta`` under a CPU
    generator seeded with ``fold_seed(seed, c)``, in float64, rounded once
    to ``dtype`` on ``device``."""
    rows = [prior.sample_beta(
        torch.Generator().manual_seed(fold_seed(seed, c)),
        1, dtype=torch.float64, device="cpu") for c in range(int(n_chains))]
    return torch.cat(rows).to(device=device, dtype=dtype)
