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
the loop takes those counts back out and adds them times the replays once
per call, so the counts stay the number of kernels that ran.

Each block records a ``loop.replay`` span (argument ``B``) and its flag
read a ``loop.flag_read`` span, and a capture ``loop.capture``
(``utils/profiling.py``).  On the graph loop a replay is timed on the card
by two events around ``graph.replay()``, read after the flag read's
synchronise; its flag read's host return bounds how late the replay can
have ended, and the tightest such bound of a call anchors the call's
device times on the host clock.  Between a flag read and the next launch the loop
records the two events only: it records each block's spans and reads the
previous block's events after the launch, while the card runs the block,
so the block boundary costs the card no more than the two event records.
"""

from __future__ import annotations

import time
from types import MappingProxyType
from typing import Callable, Sequence

import torch

from .utils.profiling import part, recorder, span

_NO_ARGS = MappingProxyType({})  # a flag read's span arguments

__all__ = ["BlockLoop", "new_stats"]


def new_stats() -> dict:
    """Counters a loop adds to: host flag reads (one per block), graph
    captures and their seconds."""
    return dict(flag_reads=0, captures=0, capture_seconds=0.0)


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

    ``passes``: the passes of one block (the ``B`` of its spans).
    ``counters``: the launch-count dicts of the kernels the block may
    launch.  ``stats``: a :func:`new_stats` dict to add to."""

    def __init__(self, block: Callable, *, passes: int, graph: bool,
                 counters: Sequence[dict], stats: dict):
        self.block = block
        self.passes = int(passes)
        self.graph = graph
        self.counters = list(counters)
        self.stats = stats
        self._g = None  # (graph, static carry, flag, launch deltas)
        # the arguments of its replay spans, one read-only dict for all
        self._args = MappingProxyType({"B": self.passes})

    def __call__(self, ctx, carry):
        rec = recorder()
        if not self.graph:
            while True:
                t0 = time.perf_counter_ns()
                with part("loop.replay"):
                    carry, flag = self.block(ctx, carry)
                t1 = time.perf_counter_ns()
                if rec is not None:
                    rec.add("loop.replay", t0, t1, self._args)
                go, read = self._read(flag)
                if rec is not None:
                    rec.add("loop.flag_read", *read, _NO_ARGS)
                if not go:
                    return carry
        flat, spec = _flatten(carry)
        if self._g is None:
            self._capture(ctx, flat, spec)
        graph, static, flag, deltas = self._g
        for dst, src in zip(static, flat):
            dst.copy_(src)
        dev = static[0].device
        stream = (torch.cuda.current_stream(dev)
                  if rec is not None and dev.type == "cuda" else None)
        replays, last, read = 0, None, None
        try:
            while True:
                # between the flag read and the launch: the events only
                t0 = time.perf_counter_ns()
                with part("loop.replay"):
                    ev0 = None if stream is None else rec.timing_event(stream)
                    graph.replay()
                    ev1 = None if stream is None else rec.timing_event(stream)
                t1 = time.perf_counter_ns()
                replays += 1
                if rec is not None:  # the card runs the block meanwhile
                    if read is not None:
                        rec.add("loop.flag_read", *read, _NO_ARGS)
                        if stream is not None:  # the last block's read
                            rec.anchor(last, read[1])
                        read = None
                    last = rec.add("loop.replay", t0, t1, self._args,
                                   stream, None if ev0 is None else (ev0, ev1))
                    rec.settle()
                go, read = self._read(flag)
                if not go:
                    return _unflatten([t.clone() for t in static], spec)
        finally:
            for counts, delta in zip(self.counters, deltas):
                for k, v in delta.items():
                    counts[k] += v * replays
            if rec is not None and read is not None:
                rec.add("loop.flag_read", *read, _NO_ARGS)
                if stream is not None:
                    rec.anchor(last, read[1])

    def _read(self, flag):
        """(go, the read's host interval); raises on a bad lane-pass."""
        t0 = time.perf_counter_ns()
        with part("loop.flag_read"):
            go, bad = flag.tolist()  # the block's one host read
        t1 = time.perf_counter_ns()
        self.stats["flag_reads"] += 1
        if bad:
            raise RuntimeError(
                f"{bad} lane-passes carried a Gamma draw that exhausted its "
                "Marsaglia-Tsang candidates (genelliptical); no draw was "
                "approximated"
            )
        return bool(go), (t0, t1)

    def _capture(self, ctx, flat, spec):
        with span("loop.capture", B=self.passes):
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
