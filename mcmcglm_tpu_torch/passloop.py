"""The free-running engine's pass loop: blocks of passes, one host read each.

Counterpart of the ``lax.while_loop`` that runs a whole ``run``,
``warmup`` or ``run_passes`` call of the JAX package on the device
(``mcmcglm_tpu/freerun.py``, ``_run`` and ``_run_pass_block``).  PyTorch
has no device loop, so the port runs a *block* of B passes and reads one
termination flag on the host per block.  A block may overshoot the quota:
every lane is idle in a pass past it, and an all-idle pass leaves the
state unchanged and consumes no random numbers, so the result does not
depend on B.

:class:`BlockLoop` runs ``block(ctx, carry) -> (carry, flag)`` until the
flag's first word is 0.  ``ctx`` (the engine) is handed in per call, so a
loop its owner caches holds no reference back to the owner.  ``carry`` is
a tuple of tensors, ``None``s and NamedTuples of tensors; ``flag`` a (2,)
int64 tensor [go, bad], where ``bad`` > 0 raises (a genelliptical Gamma
draw that exhausted its candidates).

* On the CPU (and on CUDA when ``graph=False``, which only the tests and
  the smoke's equality check ask for) the block runs eagerly.
* On CUDA the block is captured once as a ``torch.cuda.CUDAGraph`` over
  static copies of the carry and replayed per block.  The captured block
  ends by copying its outputs back into the static inputs, so replays
  chain on the device without host copies; the carry is copied in once
  per call and cloned out at the end.  The warm-up that capture needs
  (lazy initialisation, the kernel library's build) runs on a throwaway
  copy of the carry, so it consumes nothing.  A failed capture raises:
  there is no eager fallback.

Kernel wrappers count their launches in module-level dicts as they
launch.  During capture they count the launches recorded into the graph;
the loop takes those counts back out and adds them once per replay, so
the counts stay the number of kernels that ran.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

__all__ = ["BlockLoop", "new_stats"]


def new_stats() -> dict:
    """Counters a loop adds to: blocks run, host flag reads, graph
    captures and their seconds."""
    return dict(blocks=0, flag_reads=0, captures=0, capture_seconds=0.0)


def _flatten(carry):
    flat, spec = [], []
    for item in carry:
        if item is None:
            spec.append(None)
        elif torch.is_tensor(item):
            spec.append(0)
            flat.append(item)
        else:  # a NamedTuple of tensors
            spec.append(type(item))
            flat.extend(item)
    return flat, spec


def _unflatten(flat, spec):
    out, i = [], 0
    for sp in spec:
        if sp is None:
            out.append(None)
        elif sp == 0:
            out.append(flat[i])
            i += 1
        else:
            n = len(sp._fields)
            out.append(sp(*flat[i:i + n]))
            i += n
    return tuple(out)


class BlockLoop:
    """Run ``block`` until its flag says stop; see the module docstring.

    ``counters``: the launch-count dicts of the kernels the block may
    launch.  ``stats``: a :func:`new_stats` dict to add to."""

    def __init__(self, block: Callable, *, graph: bool,
                 counters: Sequence[dict], stats: dict):
        self.block = block
        self.graph = graph
        self.counters = list(counters)
        self.stats = stats
        self._g = None  # (graph, static carry, flag, launch deltas)

    def __call__(self, ctx, carry):
        if not self.graph:
            while True:
                carry, flag = self.block(ctx, carry)
                if not self._read(flag):
                    return carry
        flat, spec = _flatten(carry)
        if self._g is None:
            self._capture(ctx, flat, spec)
        graph, static, flag, deltas = self._g
        for dst, src in zip(static, flat):
            dst.copy_(src)
        while True:
            graph.replay()
            for counts, delta in zip(self.counters, deltas):
                for k, v in delta.items():
                    counts[k] += v
            if not self._read(flag):
                return _unflatten([t.clone() for t in static], spec)

    def _read(self, flag) -> bool:
        go, bad = flag.tolist()  # the block's one host read
        self.stats["blocks"] += 1
        self.stats["flag_reads"] += 1
        if bad:
            raise RuntimeError(
                f"{bad} lane-passes carried a Gamma draw that exhausted its "
                "Marsaglia-Tsang candidates (genelliptical); no draw was "
                "approximated"
            )
        return bool(go)

    def _capture(self, ctx, flat, spec):
        t0 = time.perf_counter()
        dev = flat[0].device
        static = [t.clone() for t in flat]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up on a throwaway copy
            self.block(ctx, _unflatten([t.clone() for t in flat], spec))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = [dict(c) for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, flag = self.block(ctx, _unflatten(static, spec))
            out_flat, _ = _flatten(out)
            for dst, src in zip(static, out_flat):
                if src is not dst:
                    dst.copy_(src)
        deltas = []
        for counts, b in zip(self.counters, before):
            deltas.append({k: counts[k] - b[k] for k in counts})
            counts.update(b)  # capture launched nothing
        torch.cuda.synchronize(dev)
        self._g = (graph, static, flag, deltas)
        self.stats["captures"] += 1
        self.stats["capture_seconds"] += time.perf_counter() - t0
