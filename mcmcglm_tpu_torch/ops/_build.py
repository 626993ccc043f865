"""Build and load the port's CUDA kernels.

The kernels live in ``mcmcglm_tpu_torch/csrc/*.cu`` with a plain C
interface.  At first use they are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/mcmcglm_tpu_torch/`` next
to the package, keyed by a hash of the source and the flags, and loaded
with ``ctypes``.  Nothing here runs at import time, and nothing falls back:
a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_battery_library", "BUILD_INFO"]

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "freerun_battery.cu"
_BUILD_ROOT = _PKG.parent / "build" / "mcmcglm_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
# filled by the first load: library path, build seconds (0.0 when the
# library was already built), nvcc's output (ptxas register/spill report)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA battery kernels cannot be built"
    )


def _build(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{BUILD_INFO['log']}"
        )
    os.replace(tmp, out)


def load_battery_library() -> ctypes.CDLL:
    """The compiled battery library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    key = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(_FLAGS).encode()
    ).hexdigest()[:16]
    out = _BUILD_ROOT / key / "libfreerun_battery.so"
    if out.exists():
        BUILD_INFO.update(seconds=0.0, log="(cached build)")
    else:
        _build(out)
    BUILD_INFO["path"] = str(out)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.battery_sums.argtypes = [P, P, P, P, P, P, I, I, I, I, F, P]
    lib.battery_commit.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, F, P]
    lib.battery_gather_commit.argtypes = [
        P, P, I, P, P, P, P, P, P, P, P, I, I, I, I, F, P,
    ]
    for fn in (lib.battery_sums, lib.battery_commit,
               lib.battery_gather_commit):
        fn.restype = I
    _LIB = lib
    return lib
