"""Build and load the port's CUDA kernels.

The kernels live in ``mcmcglm_tpu_torch/csrc/*.cu`` (with the shared
headers ``csrc/*.cuh``) behind a plain C interface.  At first use every
source is compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per
source, all started together, and the objects are linked into one shared
library under ``build/mcmcglm_tpu_torch/`` next to the package, keyed by a
hash of every source, every header and the flags; the library is loaded
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

__all__ = ["load_library", "BUILD_INFO"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "mcmcglm_tpu_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v", "-c"]
_LINK_FLAGS = [*_ARCH, "-shared"]

_LIB = None
# filled by the first load: library path, whether it was already built
# (``cached``), build seconds (0.0 when it was), nvcc's output (ptxas
# register/spill report; kept as nvcc.log beside the library, so a cached
# build reports it too)
BUILD_INFO: dict = {}


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


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
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _run(cmds):
    """Run the commands in parallel; raise with the log of the first that
    fails.  Returns the concatenated output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], None
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, out)
    finally:  # a timeout or an interrupt leaves no compiler running
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return "".join(logs)


def _build(out: Path, sources) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    log = _run([[nvcc, *_COMPILE_FLAGS, "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)])
    tmp = out.with_suffix(f".{tag}.so")
    log += _run([[nvcc, *_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = log
    for obj in objs:
        obj.unlink()
    # the log goes first, so that a library on disk always has its log
    log_tmp = out.parent / f"nvcc.{tag}.log"
    log_tmp.write_text(log)
    os.replace(log_tmp, out.with_name("nvcc.log"))
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    # every entry point takes (fam, param, rfam, rlink): the template family
    # id, its scalar, and the composed route's runtime family and link
    fam = [I, F, I, I]
    lib.battery_sums.argtypes = [P, P, P, P, P, P, I, I, I, *fam, P]
    lib.battery_commit.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, *fam,
                                   P]
    gather = [P, P, I, P, P, P, P, P, P, P, P, I, I, I, *fam, P]
    lib.battery_gather_commit.argtypes = gather
    lib.battery_gather_commit_bf16.argtypes = gather
    lib.fused_coord_update.argtypes = [
        P, P, P, P, P, P, P, P, I, I, I, I, U, U, U, F, I, I, *fam, I, F, F,
        F, P,
    ]
    lib.fused_sweep.argtypes = [
        P, P, P, P, P, P, P, I, I, I, I, U, U, U, F, I, I, *fam, I, F, F, F,
        P,
    ]
    # the automaton kernels: host arrays of pointers, ints and floats
    lib.pass_propose.argtypes = [P, P, P, P]
    lib.pass_advance.argtypes = [P, P, P, P]
    for fn in (lib.battery_sums, lib.battery_commit,
               lib.battery_gather_commit, lib.battery_gather_commit_bf16,
               lib.fused_coord_update, lib.fused_sweep, lib.pass_propose,
               lib.pass_advance):
        fn.restype = I


def load_library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(_COMPILE_FLAGS + _LINK_FLAGS).encode())
    for path in sources + headers:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    out = _BUILD_ROOT / h.hexdigest()[:16] / "libmcmcglm_kernels.so"
    BUILD_INFO["cached"] = out.exists()
    if BUILD_INFO["cached"]:
        saved = out.with_name("nvcc.log")
        BUILD_INFO.update(seconds=0.0, log=saved.read_text()
                          if saved.exists() else "(cached build)")
    else:
        _build(out, sources)
    BUILD_INFO["path"] = str(out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _LIB = lib
    return lib
