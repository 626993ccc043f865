"""Profiling helpers: the counterpart of ``mcmcglm_tpu/utils/profiling.py``,
and the port's span recorder.

``trace(logdir)`` captures the enclosed block with ``torch.profiler`` (the
host, and the card's kernels where CUDA is present) and writes a Chrome
trace to ``logdir/trace.json``; ``time_block`` is the wall-clock analogue,
which synchronises the CUDA devices of the tensors it is given before the
clock stops, so that asynchronous launches cannot fake a time.

**Spans.**  The engines record spans into one recorder of this module, on
by default: one call span per engine call that runs passes or fused sweeps
(``freerun.run``, ``freerun.warmup``, ``freerun.run_passes``,
``freerun.warmup_passes``, ``fused.run``, with arguments ``C`` and
``n_sweeps``) and inside it ``loop.capture``, ``loop.replay`` (argument
``B``, the block's passes) and ``loop.flag_read`` per block of passes
(``passloop.BlockLoop``), or ``fused.sweep`` per fused sweep.  A span
holds its name, its id, its parent's id, the id of the engine call it
belongs to (``call``, shared by every span of that call), its integer
arguments, its host interval (``t0``, ``t1``: ``time.perf_counter_ns``),
whether a torch profiler was active when it opened (``profiled``) and, for
the spans the card times, the device interval.  The recorder is a ring of
the last ``RING`` spans that counts what it drops (``dropped_spans()``);
it outlives every engine.  ``spans()`` reads it as dicts;
``set_span_recording(False)`` switches it off (``True`` back on).

The pooled monitor (``parallel/pooled.py`` and ``run_thinned``) records
``pooled.fold`` (a kept block folded into the moments and the ESS
state), ``pooled.merge`` (one gather over a chain group, arguments
``bytes``, sent by this rank, and ``ranks``) and ``pooled.summary`` (the
combination after the merges), each a call span of its own beside the
engine's calls, never around them.  The merge, the summary and the fold
of a thin=1 call are synced spans (:func:`synced_span`): host intervals
that close once the card has finished the work they queued (a
collective's included), with no CUDA events, so that they stay out of
the chain of device spans below.  The per-block fold of a thinned loop
is a plain span and does not synchronise.

**Device intervals.**  On CUDA, a ``loop.replay`` of the graph loop and a
``fused.sweep`` are timed by two CUDA timing events recorded on the
current stream just before and just after the replay or the sweep's
launches, never inside a captured graph, from a pool the recorder reuses.
Nothing synchronises for them: a replay's events are read once its
block's flag read has synchronised (after the next block's launch, while
the card runs it); a sweep's once they are complete (at the next sweep,
or at ``spans()`` after the caller's own synchronise).  Each such span
gets ``dev_us``, the elapsed time between its two events, and ``gap_us``,
the elapsed time from the end event of the device span read before it
(``prev``, its id) to its start event: the device time between the two.
Gaps are only ever such elapsed times.  Chained, they place every device
span of a run on one device relative to the others.

Each engine call is put on the host clock by one anchor.  A free-running
call on the graph loop is anchored at one of its flag reads: each read
returns after its replay's end event (the flag's copy follows the replay
on the stream), so every read bounds how late the call's device times can
lie, and the call takes the tightest bound: the replay whose read allows
the earliest placement ends at that read's host return, and every other
replay ends at or before its own read's return.  (The last read alone
placed earlier replays up to the difference of two reads' host latencies
after their own reads, tens of microseconds where a block is shorter than
the host's work between two reads.)
Any other call's first device span is placed to start when its start
event was enqueued, exact when the stream was idle as the call began (as
after a synchronise).  Every other device span of the call is placed from
the anchor by the chained elapsed times (``dev0``, ``dev1``; ``None``
where a span has no device interval).  On an H100 80GB HBM3 (poisson/log,
C=64, the kernel-route pass) a replay's end lay 0 to 15 us (the 95th
percentile) before its own flag read's host return, and two consecutive
free-running calls' anchors agreed within 7 us; fused calls' enqueue
anchors agreed within 0.7 ms.

**Profiler ranges.**  While a torch profiler is active, each span also
opens a range of its name on the profiler's host timeline, so that the
spans sit beside the kernels in ``trace()``'s Chrome trace; ``part(name)``
opens such a range alone, and ``ranged(name)`` around each call of a
function (the pass's parts, ``pass.*``).  They are function-scope ranges
(``_RecordFunctionFast``), not the user-scope ranges of
``torch.profiler.record_function``: the profiler mirrors a user-scope
range onto the device timeline as an annotation event, which a reader of
the profiled device operations would count as one more operation.  With
no profiler active a range costs one check.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Optional

import torch

__all__ = ["trace", "time_block", "Timer", "RING", "Recorder", "recorder",
           "span", "synced_span", "device_span", "part", "ranged", "spans",
           "dropped_spans", "set_span_recording", "reset_spans"]

# spans the recorder keeps: a limit of the program, not of any one run.
# The pass loop records two spans a block (a replay and its flag read); at
# the kernel route's shortest blocks (~0.54 ms for 32 passes at C=64 on an
# H100) the ring holds the last ~140 s of a run, and drops (and counts)
# the older spans.  A full ring takes 179 MiB of host memory, ~360 bytes
# a span (its resident size with the card's fields set, Python 3.12).
RING = 1 << 19
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile of the enclosed block into ``logdir/trace.json``;
    yields the ``torch.profiler.profile`` (``key_averages()`` and the
    like)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    def __init__(self):
        self.seconds: Optional[float] = None


def _devices(obj):
    if torch.is_tensor(obj):
        yield obj.device
    elif isinstance(obj, (str, torch.device)):
        yield torch.device(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _devices(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _devices(v)


@contextlib.contextmanager
def time_block(sync=None):
    """Wall-clock a block; every CUDA device of ``sync`` (a tensor or a
    device, or lists, tuples and dicts of them) is synchronised before the
    clock stops.  Yields a :class:`Timer` whose
    ``.seconds`` is set on exit."""
    t = Timer()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        for dev in {x for x in _devices(sync) if x.type == "cuda"}:
            torch.cuda.synchronize(dev)
        t.seconds = time.perf_counter() - t0


# -- spans ---------------------------------------------------------------


def _host_range(name: str):
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(name)


def part(name: str):
    """A range ``name`` on the profiler's host timeline while a torch
    profiler is active, else nothing (module docstring)."""
    if torch.autograd._profiler_enabled():
        return _host_range(name)
    return _NULL


def ranged(name: str):
    """Decorator: each call of the function runs inside :func:`part`
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with part(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class Span:
    """One span of the recorder (module docstring); its own context
    manager when :func:`span` or :func:`device_span` made it.  ``_dev`` is
    the CUDA device index whose events time it, or None."""

    __slots__ = ("name", "id", "parent", "call", "args", "t0", "t1",
                 "profiled", "dev_us", "gap_us", "prev", "_rec", "_range",
                 "_dev", "_stream", "_ev", "_chain", "_pos", "_call",
                 "_anchor")

    def __init__(self, rec, name, args, stream=None):
        self._rec, self.name, self.args, self._stream = rec, name, args, stream
        self._dev = None if stream is None else stream.device_index
        self.t0 = self.t1 = self.dev_us = self.gap_us = self.prev = None
        self._ev = self._chain = self._pos = self._anchor = self._range = None

    def _open(self, stack):
        """Give the span its id, parent and call, and put it in the ring."""
        rec = self._rec
        self.id = next(rec._ids)
        self.parent = stack[-1].id if stack else None
        self._call = stack[0] if stack else None  # None: the call itself
        self.call = stack[0].id if stack else self.id
        self.profiled = torch.autograd._profiler_enabled()
        if len(rec.ring) == rec.ring.maxlen:
            rec.dropped += 1
        rec.ring.append(self)

    def _timed(self, ev0, ev1, enqueued_ns):
        """Hand the span's two recorded events to the recorder; the first
        timed span of a call anchors it at ``enqueued_ns`` by default."""
        self._ev = (ev0, ev1)
        self._rec._pending.append(self)
        call = self._call or self
        if call._anchor is None:
            call._anchor = (self, "start", enqueued_ns)

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        self._open(stack)
        stack.append(self)
        if self.profiled:
            self._range = _host_range(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        if self._stream is not None:
            rec.settle()
            self._ev = rec.timing_event(self._stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        if self._ev is not None:
            ev0, self._ev = self._ev, None
            if exc_type is None:
                self._timed(ev0, rec.timing_event(self._stream), self.t0)
            else:  # no device interval for a span that raised
                rec._pool[self._dev].append(ev0)
        self.t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        rec._stack().pop()
        return False

    def _mapped(self):
        """(dev0, dev1) on the host clock in ns, or (None, None)."""
        a = (self._call or self)._anchor
        if self._pos is None or a is None:
            return None, None
        asp, which, ns = a
        if asp._pos is None or asp._chain != self._chain:
            return None, None
        a_end = ns if which == "end" else ns + 1e3 * asp.dev_us
        dev1 = a_end + 1e3 * (self._pos - asp._pos)
        return round(dev1 - 1e3 * self.dev_us), round(dev1)

    def as_dict(self) -> dict:
        dev0, dev1 = self._mapped()
        return dict(name=self.name, id=self.id, parent=self.parent,
                    call=self.call, args=dict(self.args), t0=self.t0,
                    t1=self.t1, dev0=dev0, dev1=dev1, dev_us=self.dev_us,
                    gap_us=self.gap_us, prev=self.prev,
                    profiled=self.profiled)


class Recorder:
    """The ring of spans, the pool of timing events and the timed spans
    whose events are not read yet."""

    def __init__(self, capacity: int = RING):
        self.enabled = True
        self.ring = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._pool: dict = {}  # device index -> free timing events
        self._pending = collections.deque()  # in recording order
        self._last = None  # the timed span read last (its end event kept)
        self._offers = []  # (timed span, host ns) anchors not weighed yet
        self._chains = itertools.count(1)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def timing_event(self, stream):
        """A timing event from the pool, recorded on ``stream`` now."""
        pool = self._pool.setdefault(stream.device_index, [])
        ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def add(self, name: str, t0: int, t1: int, args: dict, stream=None,
            events=None) -> Span:
        """Record a span that has already run from host time ``t0`` to
        ``t1``, inside the spans open now; ``events`` its two timing
        events, recorded on ``stream``.  The pass loop records its blocks
        so, after the next launch, when the device is busy."""
        sp = Span(self, name, args, stream)
        sp._open(self._stack())
        sp.t0, sp.t1 = t0, t1
        if events is not None:
            sp._timed(events[0], events[1], t0)
        return sp

    def anchor(self, sp: Span, host_ns: int) -> None:
        """Offer ``host_ns``, the host return of a flag read that followed
        timed span ``sp``, as the anchor of ``sp``'s engine call: placing
        ``sp``'s end there is the latest placement that read allows.  The
        call keeps the offer that places its device times earliest (module
        docstring); an offer is weighed once ``sp``'s events are read."""
        self._offers.append((sp, host_ns))
        self._weigh()

    def _weigh(self) -> None:
        """Weigh the offers whose spans have device positions."""
        keep = []
        for sp, ns in self._offers:
            if sp._pos is None:
                keep.append((sp, ns))
                continue
            call = sp._call or sp
            a = call._anchor
            # a call's anchors share its chain; an offer on another chain
            # (a device span of another device between) replaces the old
            if (a is None or a[1] != "end" or a[0]._chain != sp._chain
                    or ns - 1e3 * sp._pos < a[2] - 1e3 * a[0]._pos):
                call._anchor = (sp, "end", ns)
        self._offers = keep

    def settle(self) -> None:
        """Read the device times of the pending spans whose end events are
        complete, in the order they were recorded; never waits."""
        q = self._pending
        while q and q[0]._ev[1].query():
            sp = q.popleft()
            ev0, ev1 = sp._ev
            sp.dev_us = 1e3 * ev0.elapsed_time(ev1)
            last = self._last
            if last is not None and last._dev == sp._dev:
                sp.gap_us = 1e3 * last._ev[1].elapsed_time(ev0)
                sp.prev, sp._chain = last.id, last._chain
                sp._pos = last._pos + sp.gap_us + sp.dev_us
            else:
                sp._chain, sp._pos = next(self._chains), sp.dev_us
            pool = self._pool[sp._dev]
            if last is not None:
                pool.append(last._ev[1])
                last._ev = None
            pool.append(ev0)
            sp._ev = (None, ev1)
            self._last = sp
        if self._offers:
            self._weigh()


_RECORDER = Recorder()


def recorder() -> Optional[Recorder]:
    """The recorder while recording is on, else None."""
    return _RECORDER if _RECORDER.enabled else None


def span(name: str, **args):
    """A span ``name`` with integer arguments ``args`` around the enclosed
    block; yields the :class:`Span`, or None while recording is off."""
    rec = _RECORDER
    return Span(rec, name, args) if rec.enabled else _NULL


@contextlib.contextmanager
def synced_span(name: str, device, **args):
    """:func:`span` whose host interval covers the device work the block
    queued: before it closes it synchronises ``device`` when that is a
    CUDA device (every stream of it, a collective's too), so ``t1`` falls
    after the block's results are ready.  Only while recording is on; it
    takes no CUDA events, so it stays out of the chain of device spans."""
    with span(name, **args) as sp:
        yield sp
        if sp is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def device_span(name: str, device, **args):
    """:func:`span`, timed on the card by two events on the current stream
    when ``device`` is a CUDA device whose stream is not capturing a
    graph."""
    rec = _RECORDER
    if not rec.enabled:
        return _NULL
    stream = None
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        stream = torch.cuda.current_stream(device)
    return Span(rec, name, args, stream)


def spans() -> list:
    """The recorder's spans, oldest first, as dicts (module docstring)."""
    rec = _RECORDER
    rec.settle()
    return [sp.as_dict() for sp in list(rec.ring)]


def dropped_spans() -> int:
    """Spans the ring has let go to hold the newest ``RING``."""
    return _RECORDER.dropped


def set_span_recording(on: bool) -> None:
    """Switch the span recorder on or off (it starts on)."""
    _RECORDER.enabled = bool(on)


def reset_spans(capacity: int = RING) -> None:
    """Start an empty recorder of ``capacity`` spans, switched on."""
    global _RECORDER
    _RECORDER = Recorder(capacity)
