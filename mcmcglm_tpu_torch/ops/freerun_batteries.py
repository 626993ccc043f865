"""Speculative proposal batteries for the free-running CGGibbs pass.

Counterpart of ``mcmcglm_tpu/ops/freerun_batteries.py``.  A battery
evaluates the K speculative slice proposals of one pass for all C chains:

    lsum[c, k] = sum_i sel(m_i != 0, ld(eta[c, i] + x[c, i] * deltas[c, k], y_i) * m_i, 0)

Three parts:

* :func:`plain_battery`, the plain PyTorch version (the counterpart of the
  XLA branch of ``run_pass_spec``): it materialises the (C, K, n) proposal
  etas, so it re-reads eta and the rows once per proposal.  It returns
  ``lsum`` and, when given the decision operands, the committed eta.
* The wrappers :func:`battery_sums`, :func:`battery_commit` and
  :func:`battery_gather_commit`, one per hand-written CUDA kernel in
  ``csrc/freerun_battery.cu`` (replacing the Pallas kernels
  ``build_battery``, ``build_battery2`` and ``build_battery3``).  On a CPU
  tensor a wrapper runs the plain version; on a CUDA tensor it launches its
  kernel or raises.  Each counts its launches in :data:`launch_counts`.
* :func:`configure_battery`, which validates ``battery_impl`` and resolves
  ``"auto"`` against the static table of the 21 built-in family/link pairs
  the kernels implement (:data:`KERNEL_FAMILIES`).  Only a family or link
  that the user registered falls outside it: no hand kernel can compile a
  Python density, so ``"auto"`` then runs the plain battery and warns.
"""

from __future__ import annotations

import logging
import warnings
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "COMPOSED_PAIRS",
    "KERNEL_FAMILIES",
    "KernelFamily",
    "battery_commit",
    "battery_gather_commit",
    "battery_sums",
    "configure_battery",
    "first_acceptor",
    "kernel_family",
    "launch_counts",
    "masked_sum",
    "plain_battery",
    "replay_delta_star",
    "reset_launch_counts",
]

_log = logging.getLogger(__name__)

# The pairs with a density path of their own in csrc/families.cuh ->
# their template family id (the FAM_* enum there).
OWN_PATHS = {
    ("gaussian", "identity"): 0,
    ("binomial", "logit"): 1,
    ("poisson", "log"): 2,
    ("negative.binomial", "log"): 3,
    ("Gamma", "log"): 4,
    ("binomial", "cloglog"): 5,
}
FAM_COMPOSED = 6  # the template id of the composed route
# runtime ids of the composed route (RF_* and LINK_* in csrc/families.cuh)
COMPOSED_FAMILIES = {"gaussian": 0, "binomial": 1, "poisson": 2,
                     "negative.binomial": 3, "Gamma": 4,
                     "inverse.gaussian": 5}
COMPOSED_LINKS = {"identity": 0, "log": 1, "logit": 2, "probit": 3,
                  "cloglog": 4, "inverse": 5, "1/mu^2": 6, "sqrt": 7,
                  "cauchit": 8}
# the links R's family objects accept for each built-in family
BUILTIN_LINKS = {
    "gaussian": ("identity", "log", "inverse"),
    "binomial": ("logit", "probit", "cauchit", "log", "cloglog"),
    "poisson": ("log", "identity", "sqrt"),
    "negative.binomial": ("log", "sqrt", "identity"),
    "Gamma": ("inverse", "identity", "log"),
    "inverse.gaussian": ("1/mu^2", "inverse", "identity", "log"),
}
# (family name, link name) -> (template family id, runtime family id,
# runtime link id) for all 21 built-in pairs: a pair's own path where it
# has one, else the composed route
KERNEL_FAMILIES = {
    (fam, link): (OWN_PATHS.get((fam, link), FAM_COMPOSED),
                  COMPOSED_FAMILIES[fam], COMPOSED_LINKS[link])
    for fam, links in BUILTIN_LINKS.items() for link in links
}
# the fifteen pairs of the composed route, in the table's order
COMPOSED_PAIRS = tuple(p for p, v in KERNEL_FAMILIES.items()
                       if v[0] == FAM_COMPOSED)
# family -> (name of the scalar extra argument the kernels take, default)
_FAMILY_PARAM = {"gaussian": ("sd", 1.0), "negative.binomial": ("size", 1.0),
                 "Gamma": ("shape", 1.0)}


class KernelFamily(NamedTuple):
    """What the kernels take for a family/link pair: the template id, the
    scalar parameter, and the composed route's runtime family and link
    ids."""

    fid: int
    param: float
    rfam: int
    rlink: int


IMPLS = ("auto", "torch", "cuda", "cuda2", "cuda3")
KERNEL_IMPLS = ("cuda", "cuda2", "cuda3")

# launches per kernel entry point, counted where each wrapper launches
launch_counts = {
    "battery_sums": 0,
    "battery_commit": 0,
    "battery_gather_commit": 0,
    "battery_gather_commit_bf16": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _family_param(name, extra) -> float:
    """The family's scalar extra argument as the kernels take it:
    inverse-gaussian's dispersion phi, or 1 / shape (in float32, as the
    plain version computes it) when only ``shape`` is given."""
    if name == "inverse.gaussian":
        if "shape" in extra and "dispersion" not in extra:
            return float(np.float32(1.0) / np.float32(float(extra["shape"])))
        return float(extra.get("dispersion", 1.0))
    pname, default = _FAMILY_PARAM.get(name, (None, 0.0))
    return float(extra[pname]) if pname in extra else default


def kernel_family(family, extra):
    """:class:`KernelFamily` for a family/link pair in
    :data:`KERNEL_FAMILIES`, else None."""
    entry = KERNEL_FAMILIES.get((family.name, family.link.name))
    if entry is None:
        return None
    fid, rfam, rlink = entry
    return KernelFamily(fid, _family_param(family.name, extra), rfam, rlink)


def _outside_table(family) -> str:
    return (f"{family.name}/{family.link.name} is not in KERNEL_FAMILIES (a "
            "user-registered family or link: no hand kernel can compile its "
            "density)")


def masked_sum(t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of sel(m != 0, t * m, 0): a selection, not a
    multiplication, so a non-finite t at a zero weight drops out."""
    return torch.where(m != 0, t * m, 0.0).sum(-1)


def first_acceptor(f, level, rem):
    """First proposal k with f[:, k] >= level and k < rem, per chain.

    Returns (any_acc (C,) bool, idx (C,) int64); idx is 0 where no
    proposal is accepted.  The first of several acceptors is the lowest
    index (``argmax`` of a uint8 cast: torch refuses bool)."""
    K = f.shape[1]
    kio = torch.arange(K, device=f.device)
    accv = (f >= level[:, None]) & (kio[None, :] < rem[:, None])
    return accv.any(1), torch.argmax(accv.to(torch.uint8), 1)


def replay_delta_star(lsum, deltas, fprior, scal):
    """The committed move of the in-kernel decision replay: scal (C, 4) =
    [level, ld0, gate, rem]; f = (lsum - ld0) + fprior."""
    f = (lsum - scal[:, 1:2]) + fprior
    any_acc, idx = first_acceptor(f, scal[:, 0], scal[:, 3])
    d_first = torch.gather(deltas, 1, idx[:, None])[:, 0]
    return torch.where((scal[:, 2] > 0) & any_acc, d_first, 0.0)


def plain_battery(eta, xg, deltas, y, ld_fn, reduce_fn, fprior=None,
                  scal=None):
    """The plain PyTorch battery: lsum (C, K) = reduce_fn(ld_fn(eta + xg *
    delta_k, y)); with ``fprior``/``scal`` also the committed eta (C, n)."""
    e = eta[:, None, :] + xg[:, None, :] * deltas[:, :, None]  # (C, K, n)
    lsum = reduce_fn(ld_fn(e, y))
    if fprior is None:
        return lsum
    dstar = replay_delta_star(lsum, deltas, fprior, scal)
    return lsum, eta + xg * dstar[:, None]


# -- the kernel wrappers -------------------------------------------------------


def _ld_fn(family, extra):
    return lambda e, y: family.log_density_eta_rel(e, y, extra)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(eta, deltas, y, m, family, extra):
    """Common CUDA-side checks; returns (lib, C, n, K, kf), kf the
    :class:`KernelFamily`."""
    if eta.device.type != "cuda":
        raise ValueError(
            f"battery kernels run on CUDA tensors (got {eta.device})"
        )
    if eta.dim() != 2 or deltas.dim() != 2:
        raise ValueError("eta must be (C, n) and deltas (C, K)")
    C, n = eta.shape
    K = deltas.shape[1]
    if not 1 <= K <= 32:
        raise ValueError(f"the battery kernels take 1 <= K <= 32, got {K}")
    kf = kernel_family(family, extra)
    if kf is None:
        raise ValueError(_outside_table(family))
    f32 = torch.float32
    _check("eta", eta, (C, n), f32, eta.device)
    _check("deltas", deltas, (C, K), f32, eta.device)
    _check("y", y, (n,), f32, eta.device)
    _check("m", m, (n,), f32, eta.device)
    from ._build import load_library

    return load_library(), C, n, K, kf


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def battery_sums(eta, xg, deltas, y, m, family, extra):
    """lsum (C, K): the battery sums only (replaces ``build_battery``)."""
    if eta.device.type == "cpu":
        return plain_battery(eta, xg, deltas, y, _ld_fn(family, extra),
                             lambda t: masked_sum(t, m))
    lib, C, n, K, kf = _prepare(eta, deltas, y, m, family, extra)
    _check("xg", xg, (C, n), torch.float32, eta.device)
    lsum = torch.empty((C, K), dtype=torch.float32, device=eta.device)
    with torch.cuda.device(eta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.battery_sums(
            eta.data_ptr(), xg.data_ptr(), deltas.data_ptr(), y.data_ptr(),
            m.data_ptr(), lsum.data_ptr(), C, n, K, *kf, stream,
        )
    _raise_on(err, "battery_sums")
    launch_counts["battery_sums"] += 1
    return lsum


def battery_commit(eta, xg, deltas, fprior, scal, y, m, family, extra):
    """(lsum (C, K), eta_new (C, n)): the battery plus the replayed
    first-acceptor decision and the eta commit (replaces
    ``build_battery2``).  scal (C, 4) = [level, ld0, gate, rem]."""
    if eta.device.type == "cpu":
        return plain_battery(eta, xg, deltas, y, _ld_fn(family, extra),
                             lambda t: masked_sum(t, m), fprior, scal)
    lib, C, n, K, kf = _prepare(eta, deltas, y, m, family, extra)
    _check("xg", xg, (C, n), torch.float32, eta.device)
    _check("fprior", fprior, (C, K), torch.float32, eta.device)
    _check("scal", scal, (C, 4), torch.float32, eta.device)
    lsum = torch.empty((C, K), dtype=torch.float32, device=eta.device)
    eta_new = torch.empty_like(eta)
    with torch.cuda.device(eta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.battery_commit(
            eta.data_ptr(), xg.data_ptr(), deltas.data_ptr(),
            fprior.data_ptr(), scal.data_ptr(), y.data_ptr(), m.data_ptr(),
            lsum.data_ptr(), eta_new.data_ptr(), C, n, K, *kf, stream,
        )
    _raise_on(err, "battery_commit")
    launch_counts["battery_commit"] += 1
    return lsum, eta_new


def battery_gather_commit(j, Xt, eta, deltas, fprior, scal, y, m, family,
                          extra):
    """:func:`battery_commit` with the row gather ``Xt[j_c]`` done inside
    the kernel (replaces ``build_battery3``).  j (C,) int32, Xt (d, n)
    float32 or bfloat16 (``x_storage="bf16"``: the kernel upcasts each row
    in registers, and its launches count as
    ``"battery_gather_commit_bf16"``)."""
    if eta.device.type == "cpu":
        return plain_battery(eta, Xt[j.long()].to(eta.dtype), deltas, y,
                             _ld_fn(family, extra),
                             lambda t: masked_sum(t, m), fprior, scal)
    lib, C, n, K, kf = _prepare(eta, deltas, y, m, family, extra)
    if Xt.dim() != 2:
        raise ValueError("Xt must be (d, n)")
    d = Xt.shape[0]
    _check("j", j, (C,), torch.int32, eta.device)
    bf16 = Xt.dtype == torch.bfloat16
    _check("Xt", Xt, (d, n), torch.bfloat16 if bf16 else torch.float32,
           eta.device)
    _check("fprior", fprior, (C, K), torch.float32, eta.device)
    _check("scal", scal, (C, 4), torch.float32, eta.device)
    lsum = torch.empty((C, K), dtype=torch.float32, device=eta.device)
    eta_new = torch.empty_like(eta)
    name = "battery_gather_commit_bf16" if bf16 else "battery_gather_commit"
    with torch.cuda.device(eta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            j.data_ptr(), Xt.data_ptr(), d, eta.data_ptr(),
            deltas.data_ptr(), fprior.data_ptr(), scal.data_ptr(),
            y.data_ptr(), m.data_ptr(), lsum.data_ptr(), eta_new.data_ptr(),
            C, n, K, *kf, stream,
        )
    _raise_on(err, name)
    launch_counts[name] += 1
    return lsum, eta_new


# -- selection -----------------------------------------------------------------


def configure_battery(eng, battery_impl, *, user_reduce_fn):
    """Validate and resolve the K-speculative battery implementation.

    ``"torch"`` is the plain battery (the JAX package's ``"xla"``);
    ``"cuda"``, ``"cuda2"`` and ``"cuda3"`` run the kernels that replace
    ``"pallas"``, ``"pallas2"`` and ``"pallas3"``.  ``"auto"`` picks
    ``"cuda3"`` on a CUDA device for a family/link pair in
    :data:`KERNEL_FAMILIES` (every built-in pair) and the constraints the
    kernels share, and ``"torch"`` otherwise, logging which it picked and
    why; on a CUDA device a pair outside the table (a user-registered
    family or link) also warns, as the JAX package warns when its auto
    selection cannot lower a Pallas battery, and so does an
    ``eval_cache="auto"`` that resolved to ``"per_obs"`` (its roundoff
    estimate reached 0.01, as for Gamma data of shape 2 at n=10,000).  An explicit kernel request
    that cannot be served raises.

    Sets ``eng.battery_impl``, ``eng.battery_reason`` and
    ``eng._kernel_family``.
    """
    if battery_impl not in IMPLS:
        raise ValueError(
            f"battery_impl must be one of {IMPLS}, got {battery_impl!r}"
        )
    kf = kernel_family(eng.family, eng.extra)
    blockers = []
    if eng.spec_k <= 1:
        blockers.append("spec_k=1 runs the one-evaluation pass")
    if eng.eval_cache != "scalar":
        blockers.append(f"eval_cache={eng.eval_cache!r} (kernels need 'scalar')")
    if not all(v.dim() == 0 for v in eng.extra.values()):
        blockers.append("non-scalar extra arguments")
    if user_reduce_fn:
        blockers.append("a custom reduce_fn")
    if eng.dtype != torch.float32:
        blockers.append(f"dtype {eng.dtype} (kernels take float32)")
    if kf is None:
        blockers.append(_outside_table(eng.family))
    if eng.device.type != "cuda":
        blockers.append(f"device {eng.device} is not CUDA")
    if battery_impl in KERNEL_IMPLS and blockers:
        raise ValueError(
            f"battery_impl={battery_impl!r} cannot serve this engine: "
            + "; ".join(blockers)
        )
    if battery_impl == "auto":
        if kf is None and eng.device.type == "cuda":
            warnings.warn(
                f"auto battery selection: {_outside_table(eng.family)}; "
                "running the plain torch battery",
                RuntimeWarning,
                stacklevel=3,
            )
        elif (eng.eval_cache == "per_obs" and eng.device.type == "cuda"
              and eng.eval_cache_reason.startswith("auto")):
            warnings.warn(
                f"auto battery selection: eval_cache='auto' chose 'per_obs' "
                f"({eng.eval_cache_reason}), which the kernels do not "
                "serve; running the plain torch battery (eval_cache='scalar' "
                "runs the kernels)",
                RuntimeWarning,
                stacklevel=3,
            )
        battery_impl = "torch" if blockers else "cuda3"
        eng.battery_reason = (
            "auto: " + ("; ".join(blockers) if blockers else
                        "CUDA device and a kernel family/link pair")
        )
        _log.info("battery_impl=%r (%s)", battery_impl, eng.battery_reason)
    else:
        eng.battery_reason = "requested"
    eng.battery_impl = battery_impl
    eng._kernel_family = kf
