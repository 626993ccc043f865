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
generators): the port's state gets the Philox key of the ``seed`` passed
in (0 by default) and pass index 1, where a fresh ``init`` starts.
:func:`convert_fused_state` does the same for
the fused engine: it cuts the padded eta back to n and takes the JAX
state's ``seed_ctr`` as the port's Philox seed (the TPU stream itself does
not carry over).  :func:`convert_lockstep_state` does it for the lockstep
engine's ``ChainState`` (sweep 0, the Philox key of ``seed``), and
:func:`convert_sharded_state` for one rank of the sharded free-running
engines: the chain rows and observation columns of a JAX sharded state
that belong to the rank, under the Philox key of its chain shard's seed.
The baselines' states carry over the same way: :func:`convert_ess_state`
(``ESSState``: beta, eta) and :func:`convert_mv_slice_state`
(``MVSliceState``: beta, lp, aux) at step 0 under the Philox key of
``seed``, and :func:`convert_advi_result` (mean, scale, ELBO trace).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .engine import ChainState
from .fused import FusedState
from .ops.philox import fold_seed, key_tensor

__all__ = ["convert_advi_result", "convert_ess_state",
           "convert_fused_state", "convert_lockstep_state",
           "convert_mv_slice_state", "convert_sharded_state",
           "convert_state"]

_INT_FIELDS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev")
_BOOL_FIELDS = ("e_aL", "e_aR", "h_aL", "h_aR", "dsep")  # DoublingState


def convert_state(jax_state, eng, seed: int = 0):
    """The port's state for ``eng`` (a port ``FreeRunCGGibbs``) from a JAX
    ``FreeRunState`` / ``QuantileState`` / ``DoublingState`` built on the
    same problem."""
    names = [k for k in eng.state_cls._fields if k not in ("key", "ctr")]
    missing = [k for k in names if not hasattr(jax_state, k)]
    if missing:
        raise ValueError(
            f"the JAX state lacks fields {missing} of the port's "
            f"{eng.state_cls.__name__}"
        )
    fields = {}
    for name in names:
        a = np.asarray(getattr(jax_state, name))
        if name == "eta" or (name == "ld0" and a.ndim > 1):
            # (C, n_pad) or pallas3's (C, S, 128) -> (C, n)
            a = a.reshape(a.shape[0], -1)[:, : eng.n]
        dtype = (torch.int32 if name in _INT_FIELDS
                 else torch.bool if name in _BOOL_FIELDS else eng.dtype)
        fields[name] = torch.tensor(a, dtype=dtype, device=eng.device)
    fields["key"] = key_tensor(seed, eng.device)
    fields["ctr"] = torch.ones((), dtype=torch.int64, device=eng.device)
    return eng.state_cls(**fields)


def convert_sharded_state(jax_state, eng, rank: int, seed: int = 0):
    """The state of rank ``rank`` of ``eng`` (a port
    ``ShardedFreeRunCGGibbs`` or ``ObsShardedFreeRunCGGibbs``) from the
    global state of the JAX package's sharded engine on the same problem
    and mesh shape: the rows of the rank's chain shard (rank // O) and the
    observation columns of its obs shard (rank % O), with the Philox key of
    ``fold_seed(seed, chain shard)`` and pass index 1 (the JAX per-shard
    keys are dropped)."""
    S, O = eng.n_chain_shards, eng.n_obs_shards
    s, o = divmod(int(rank), O)
    C = np.asarray(jax_state.beta).shape[0]
    rows = slice(s * C // S, (s + 1) * C // S)
    n_loc = eng.inner.n
    cols = slice(o * n_loc, (o + 1) * n_loc)
    fields = {}
    for name in eng.inner.state_cls._fields:
        if name in ("key", "ctr") or not hasattr(jax_state, name):
            continue  # convert_state names a missing field
        a = np.asarray(getattr(jax_state, name))
        if name == "eta" or (name == "ld0" and a.ndim > 1):
            # (C, n_pad) or pallas3's (C, S, 128): the slab's columns
            a = a.reshape(a.shape[0], -1)[:, cols]
        fields[name] = a[rows]
    return convert_state(types.SimpleNamespace(**fields), eng.inner,
                         seed=fold_seed(seed, s))


def convert_lockstep_state(jax_state, eng, seed: int = 0,
                           adapted: bool = False) -> ChainState:
    """The port's ``ChainState`` for ``eng`` (a port ``CGGibbs``) from a
    JAX ``ChainState`` of the same problem, its arrays read through numpy
    (the per-chain threefry keys are dropped).  ``adapted`` says whether
    its kernel-state slot holds warmup-adapted log widths."""
    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=eng.dtype, device=eng.device)

    return ChainState(
        beta=tensor(jax_state.beta),
        eta=tensor(jax_state.eta),
        ld_cur=tensor(jax_state.ld_cur),
        kernel_state=tensor(jax_state.kernel_state),
        key=key_tensor(seed, eng.device),
        sweep=0,
        chain_tuning={k: tensor(v) for k, v in
                      dict(jax_state.chain_tuning).items()},
        adapted=bool(adapted),
    )


def convert_fused_state(jax_state, eng):
    """The port's ``FusedState`` for ``eng`` (a port ``FusedCGGibbs``) from
    a JAX ``FusedState`` built on the same problem, at sweep 0."""
    beta = np.asarray(jax_state.beta)
    eta = np.asarray(jax_state.eta)[:, : eng.n]
    f32 = torch.float32
    return FusedState(
        beta=torch.tensor(beta, dtype=f32, device=eng.device),
        eta=torch.tensor(eta, dtype=f32, device=eng.device),
        seed=int(np.asarray(jax_state.seed_ctr)),
        sweep=0,
    )


def convert_ess_state(jax_state, eng, seed: int = 0):
    """The port's ``ESSState`` for ``eng`` (a port ``EllipticalSliceGLM``)
    from a JAX ``ESSState`` of the same problem: its beta and eta, step 0
    and the Philox key of ``seed`` (the per-chain threefry keys are
    dropped)."""
    from .baselines.ess_mv import ESSState

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=eng.dtype, device=eng.device)

    return ESSState(tensor(jax_state.beta), tensor(jax_state.eta),
                    key_tensor(seed, eng.device), 0)


def convert_mv_slice_state(jax_state, eng, seed: int = 0):
    """The port's ``MVSliceState`` for ``eng`` (a port hyperrect, latent or
    quantile slice sampler) from a JAX ``MVSliceState`` of the same
    problem: beta, the cached log posterior and the kernel state (the
    latent widths (C, d), else (C,)), step 0 and the Philox key of
    ``seed``."""
    from .baselines.mv_slice import MVSliceState

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=eng.dtype, device=eng.device)

    return MVSliceState(tensor(jax_state.beta), tensor(jax_state.lp),
                        key_tensor(seed, eng.device), tensor(jax_state.aux),
                        0)


def convert_advi_result(jax_result, device="cuda"):
    """The port's ``ADVIResult`` from a JAX ``ADVIResult``: mean, scale and
    ELBO trace in their own dtype on ``device`` (default "cuda", which
    raises without CUDA)."""
    from .api import entry_device
    from .baselines.advi import ADVIResult

    device = entry_device(device, "convert_advi_result")
    return ADVIResult(*(torch.tensor(np.asarray(a), device=device)
                        for a in jax_result))
