"""Carry a JAX engine state over into the port.

The sampler's "weights" are its state: together with the same X, y,
prior and tuning, :func:`convert_state` lets the port continue a chain
that the JAX package (``mcmcglm_tpu``) started, or replay one of its
passes.  The state's arrays are read through numpy, so this module never
imports JAX.  It undoes the JAX package's Pallas layouts:

* the observation axis padded to a lane multiple by the Pallas batteries
  is cut back to n;
* the ``(C, S, 128)`` eta of the ``"pallas3"`` battery is reshaped back to
  ``(C, n)``.

The JAX PRNG key does not carry over (the two packages use different
generators): the port's state gets the ``torch.Generator`` passed in, or a
fresh one seeded with 0.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_state"]

_INT_FIELDS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev")


def convert_state(jax_state, eng, generator=None):
    """The port's state for ``eng`` (a port ``FreeRunCGGibbs``) from a JAX
    ``FreeRunState`` / ``QuantileState`` built on the same problem."""
    names = eng.state_cls._fields
    missing = [k for k in names if not hasattr(jax_state, k)]
    if missing:
        raise ValueError(
            f"the JAX state lacks fields {missing} of the port's "
            f"{eng.state_cls.__name__}"
        )
    fields = {}
    for name in names:
        if name == "key":
            continue
        a = np.asarray(getattr(jax_state, name))
        if name == "eta" or (name == "ld0" and a.ndim > 1):
            # (C, n_pad) or pallas3's (C, S, 128) -> (C, n)
            a = a.reshape(a.shape[0], -1)[:, : eng.n]
        dtype = torch.int32 if name in _INT_FIELDS else eng.dtype
        fields[name] = torch.tensor(a, dtype=dtype, device=eng.device)
    fields["key"] = eng._generator(0 if generator is None else generator)
    return eng.state_cls(**fields)
