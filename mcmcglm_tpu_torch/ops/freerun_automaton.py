"""The free-running pass on the card: two hand-written kernels around the
battery.

``csrc/freerun_automaton.cu`` holds ``pass_propose`` and ``pass_advance``,
one thread per chain, which run a pass's per-chain work on either side of
the unchanged battery kernel (``battery_gather_commit`` for
``battery_impl="cuda3"``, ``battery_commit`` for ``"cuda2"``): a pass is
three launches where the PyTorch pass (``ops/freerun_passes.py``,
``run_pass_spec``) is about 250.  They have no TPU counterpart (the JAX
package leaves this work to XLA).  The PyTorch pass stays the plain version
they are held against, and serves every configuration the rule below sends
to ``"torch"``.

* :func:`configure_pass` applies the rule and records it on the engine as
  ``eng.pass_impl`` ("cuda" or "torch") and ``eng.pass_impl_reason``.
  "cuda" needs a CUDA device, the "cuda3" or
  "cuda2" battery, ``spec_k`` >= 2, the slice coordinate sampler with the
  stepping_out or quantile kernel (with or without ``pseudo_adapt``), an
  :class:`~mcmcglm_tpu_torch.models.priors.IIDPrior` whose distribution is
  in ``KERNEL_PRIORS``, and no obs-shard ``combine_sums``.
* :func:`make_block` is the engine's block of passes on that route (the
  pass loop captures it as one CUDA graph).  The kernels update the
  registers, ``beta``, ``logw``, ``qloc``, the sweep counts, the pass index
  and the pass budget in place, so the block works on buffers the loop
  owns: under capture the graph's static carry, and eagerly one clone per
  block.  The draws buffers are written in place, as on the PyTorch route.
* :func:`run_pass_kernels` is one eager block of one pass, with
  ``run_pass_spec``'s signature: what the card tests and ``chip_smoke.py``
  hold against the PyTorch pass.

The kernels' launches are counted in :data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..models.priors import IIDPrior
from ..utils.profiling import part
from .freerun_batteries import _raise_on, battery_commit, battery_gather_commit
from .fused_cggibbs import KERNEL_PRIORS, kernel_prior

__all__ = [
    "PASS_KERNELS",
    "configure_pass",
    "launch_counts",
    "make_block",
    "reset_launch_counts",
    "run_pass_kernels",
]

# the slice kernels the automaton kernels implement
PASS_KERNELS = ("stepping_out", "quantile")
# uniforms of a coordinate begin (level, position, stepping-out split)
_N_BEGIN = 3

launch_counts = {"pass_propose": 0, "pass_advance": 0}

# struct Ptrs of csrc/freerun_automaton.cu, in order
_PTRS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev", "sc",
         "level", "L", "R", "b0", "lp0", "w", "xprop", "ld0",
         "beta", "logw", "qloc", "draws", "nevbuf",
         "key", "quota", "stepout", "ctr", "budget",
         "deltas", "fprior", "scal", "xs", "Ls", "Rs", "u", "act", "flag",
         "lsum")
# the state's fields the kernels write in place
_WRITTEN = ("beta", "ctr", "logw", "j", "phase", "stepdir", "level", "L",
            "R", "budL", "budR", "b0", "lp0", "w", "xprop", "n_shrink",
            "nev", "ld0", "qloc")
_INT_REGS = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev")
_FLOAT_REGS = ("level", "L", "R", "b0", "lp0", "w", "xprop", "ld0")
_LOG_2PI = math.log(2.0 * math.pi)
# a lane's coordinate begin (BEGIN_* in the CUDA source)
_BEGIN_STEP, _BEGIN_SHRINK, _BEGIN_PER_LANE = 0, 1, 2


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def configure_pass(eng) -> None:
    """Set ``eng.pass_impl`` ("cuda" or "torch") and ``eng.pass_impl_reason``
    from what the engine can observe (module docstring); an engine that
    changes its battery or its reduction after construction (the
    obs-sharded engine) calls it again."""
    blockers = []
    if eng.device.type != "cuda":
        blockers.append(f"device {eng.device} is not CUDA")
    if eng.battery_impl not in ("cuda3", "cuda2"):
        blockers.append(f"battery_impl={eng.battery_impl!r} (the kernels "
                        "sit around 'cuda3' or 'cuda2')")
    if eng.spec_k < 2:
        blockers.append(f"spec_k={eng.spec_k} (the kernels take 2 to 32)")
    if eng.coord_sampler != "slice":
        blockers.append(f"coord_sampler={eng.coord_sampler!r}")
    elif eng.slice_kernel not in PASS_KERNELS:
        blockers.append(f"slice_kernel={eng.slice_kernel!r} (the kernels "
                        f"run {' and '.join(PASS_KERNELS)})")
    prior = eng.prior
    if type(prior) is not IIDPrior:  # a subclass may redefine its density
        blockers.append(f"a {type(prior).__name__} (the kernels take an "
                        "IIDPrior)")
    elif type(prior.dist) not in KERNEL_PRIORS:
        blockers.append(f"an IIDPrior of {type(prior.dist).__name__}, not "
                        "in KERNEL_PRIORS")
    if eng.combine_sums is not None:
        blockers.append("an obs shard's combine_sums")
    if blockers:
        eng.pass_impl, eng.pass_impl_reason = "torch", "; ".join(blockers)
    else:
        eng.pass_impl = "cuda"
        eng.pass_impl_reason = (
            f"CUDA device, battery {eng.battery_impl!r}, spec_k="
            f"{eng.spec_k}, slice kernel {eng.slice_kernel!r}, IID "
            f"{type(prior.dist).__name__} prior")


def _params(eng, C, S, adapt, begin):
    """The kernels' Params: (int32 array, float32 array) of ctypes."""
    pid, (p0, p1, p2) = kernel_prior(eng.prior.dist)
    # the Normal's 0.5 log(2 pi), the Uniform's width (both rounded once to
    # float32, as models/priors.py makes them)
    pc = 0.5 * _LOG_2PI if pid == 0 else p1 - p0 if pid == 5 else 0.0
    quantile = eng.slice_kernel == "quantile"
    ints = [C, eng.d, eng.spec_k, S, int(quantile), int(eng.q_adapt),
            int(eng.q_family == "normal"), pid, eng.max_shrink,
            eng.max_stepouts, int(bool(adapt)), begin]
    r, q_scale = eng._adapt_rate, eng.q_scale
    # the fixed pseudo-target's constants, as quantile_logpdf forms them
    q_norm = float(np.log(q_scale) + 0.5 * np.log(2.0 * np.pi)) \
        if quantile else 0.0
    floats = [eng.q_loc, q_scale, q_norm, math.pi * q_scale, p0, p1, p2, pc,
              r, 1.0 - r, eng.adapt_c, eng.q_c, 0.5 * _LOG_2PI]
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def _workspace(C, K, device):
    f32 = torch.float32

    def z(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=device)

    return dict(deltas=z(C, K), fprior=z(C, K), scal=z(C, 4), xs=z(C, K),
                Ls=z(C, K), Rs=z(C, K), u=z(C, K + _N_BEGIN),
                act=z(C, dtype=torch.int32),
                flag=torch.zeros(1, dtype=torch.int32, device=device))


def _check_state(eng, s, sc, draws, nevbuf):
    """The layouts the kernels index: raises on any other."""
    C = s.beta.shape[0]
    if s.key.dtype != torch.int64 or s.key.shape != (2,) or \
            s.ctr.dtype != torch.int64 or s.ctr.dim() != 0:
        raise ValueError("state.key must be (2,) and state.ctr 0-d int64")
    for name in _INT_REGS + _FLOAT_REGS:
        t = getattr(s, name)
        want = torch.int32 if name in _INT_REGS else torch.float32
        if t.dtype != want or tuple(t.shape) != (C,):
            raise ValueError(f"state.{name} must be ({C},) {want}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name in ("beta", "logw") + (("qloc",) if eng.q_adapt else ()):
        t = getattr(s, name)
        if t.dtype != torch.float32 or tuple(t.shape) != (C, eng.d):
            raise ValueError(f"state.{name} must be ({C}, {eng.d}) float32")
    if sc.dtype != torch.int32 or tuple(sc.shape) != (C,):
        raise ValueError(f"sweep_count must be ({C},) int32")
    if draws is not None:
        S = draws.shape[1]
        if (draws.dtype != torch.float32 or tuple(draws.shape) != (C, S, eng.d)
                or nevbuf.dtype != torch.int32
                or tuple(nevbuf.shape) != (C, S)):
            raise ValueError(f"draws must be ({C}, S, {eng.d}) float32 and "
                             f"nevbuf ({C}, S) int32")
    for name, t in [*zip(s._fields, s), ("sweep_count", sc),
                    ("draws", draws), ("nevbuf", nevbuf)]:
        if t is not None and (not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")


def _launch(name, table, ints, floats, device):
    from ._build import load_library

    lib = load_library()
    ptrs = (ctypes.c_void_p * len(_PTRS))(*[
        None if table[k] is None else table[k].data_ptr() for k in _PTRS])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(ptrs, ints, floats, stream)
    _raise_on(err, name)
    launch_counts[name] += 1


def _pass(eng, s, sc, draws, nevbuf, budget, quota, stepout, ws, ints,
          floats):
    """One pass in place on owned buffers; returns the state with the
    battery's new eta."""
    table = dict(zip(s._fields, s))
    table.setdefault("qloc", None)
    table.update(ws, sc=sc, draws=draws, nevbuf=nevbuf, budget=budget,
                 quota=quota, stepout=stepout, lsum=None)
    with part("pass.propose"):
        _launch("pass_propose", table, ints, floats, eng.device)
    if eng.battery_impl == "cuda3":
        lsum, eta = battery_gather_commit(
            s.j, eng._Xt_rows, s.eta, ws["deltas"], ws["fprior"], ws["scal"],
            eng.y, eng._mask, eng.family, eng._extra_host)
    else:
        lsum, eta = battery_commit(
            s.eta, eng.Xt[s.j.long()], ws["deltas"], ws["fprior"],
            ws["scal"], eng.y, eng._mask, eng.family, eng._extra_host)
    table["lsum"] = lsum
    with part("pass.advance"):
        _launch("pass_advance", table, ints, floats, eng.device)
    return s._replace(eta=eta)


def _begin_mode(shrink_only, stepout):
    if stepout is not None and not shrink_only:
        return _BEGIN_PER_LANE
    return _BEGIN_SHRINK if shrink_only else _BEGIN_STEP


def _own(s, sc, budget):
    """Copies of the fields the kernels write in place."""
    s = s._replace(**{k: getattr(s, k).clone() for k in _WRITTEN
                      if k in s._fields})
    return s, sc.clone(), budget.clone()


def make_block(B: int, adapt: bool, shrink_only):
    """The kernel route's block of B passes, ``block(eng, carry) -> (carry,
    flag)`` with the carry of ``FreeRunCGGibbs._block_fn``."""

    def block(eng, carry):
        s, sc, draws, nevbuf, budget, bad, quota, stepout = carry
        if not torch.cuda.is_current_stream_capturing():
            s, sc, budget = _own(s, sc, budget)  # eager: the one clone
        _check_state(eng, s, sc, draws, nevbuf)
        C = sc.shape[0]
        S = 0 if draws is None else int(draws.shape[1])
        ints, floats = _params(eng, C, S, adapt,
                               _begin_mode(shrink_only, stepout))
        ws = _workspace(C, eng.spec_k, eng.device)
        for _ in range(B):
            s = _pass(eng, s, sc, draws, nevbuf, budget, quota, stepout, ws,
                      ints, floats)
        go = ((sc < quota).any() & (budget > 0)).to(torch.int64)
        return ((s, sc, draws, nevbuf, budget, bad, quota, stepout),
                torch.stack([go, bad]))

    return block


def run_pass_kernels(eng, s, sweep_count, draws, nevbuf, n_sweeps,
                     adapt: bool, shrink_only, stepout_sweeps=None,
                     budget: int = 1):
    """One pass of the kernel route, ``run_pass_spec``'s counterpart: an
    eager :func:`make_block` of one pass with a pass budget of ``budget``
    (0 idles every lane), so the caller's state and sweep counts are
    copied first (the draws buffers are written in place, as there)."""
    def scalar(v):
        return torch.full((), int(v), dtype=torch.int64, device=eng.device)

    stepout = None if stepout_sweeps is None else scalar(stepout_sweeps)
    carry = (s, sweep_count, draws, nevbuf, scalar(budget), scalar(0),
             scalar(n_sweeps), stepout)
    (s, sc, draws, nevbuf, *_), _ = make_block(1, adapt, shrink_only)(
        eng, carry)
    return s, sc, draws, nevbuf
