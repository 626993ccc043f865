"""ctypes bindings for the port's native host-side diagnostics.

Counterpart of ``mcmcglm_tpu/native/__init__.py``, which the port cannot
import (``mcmcglm_tpu/__init__.py`` loads jax).  ``hostutils.cpp`` is
compiled with ``g++ -O3 -shared -fopenmp`` (without OpenMP if that fails)
at first use, into ``build/mcmcglm_tpu_torch/native-<hash>/`` next to the
package, keyed by a hash of the source; concurrent first uses build into
private names and rename.  Where no compiler exists :func:`load` returns
None and :mod:`..diagnostics` uses its numpy versions, as the JAX package
does.  Host C++ only: nothing here touches the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["ess_bulk", "load"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = Path(__file__).resolve().with_name("hostutils.cpp")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mcmcglm_tpu_torch"


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / f"native-{digest}" / "libhostutils.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    for openmp in (["-fopenmp"], []):
        cmd = ["g++", "-O3", "-fPIC", "-shared", *openmp, "-o", str(tmp),
               str(_SRC)]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return True
    return False


def load():
    """The loaded CDLL, built on first call, or None without a compiler."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        out = _library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        D = ctypes.POINTER(ctypes.c_double)
        lib.ess_bulk.restype = ctypes.c_int
        lib.ess_bulk.argtypes = [D, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, D]
        _LIB = lib
        return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ess_bulk(samples: np.ndarray):
    """Native per-parameter bulk ESS for (C, K, D) or (C, K) float64
    samples, as a (D,) array; None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, dtype=np.float64)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    C, K, D = samples.shape
    out = np.empty(D, np.float64)
    if lib.ess_bulk(_ptr(samples), C, K, D, _ptr(out)) != 0:
        return None
    return out

