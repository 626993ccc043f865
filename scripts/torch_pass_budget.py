"""Pass-time budget: the free-running device pass split into named parts, at
the bench configuration on the card.

The port's counterpart of three JAX scripts whose parts overlap:

  pass_budget.py        A (full pass), B (bare battery kernel, chained
                        eta -> eta), C (3-stream floor), D (scatters), E
                        (prior battery), F (proposal generation), G
                        (per-pass RNG)                    -> A, B, C, D, E, F, G
  profile_pass.py       the full pass per pass; the isolated evaluation;
                        streaming ops of the same footprint
                                                          -> A, B, C
  probe_components.py   the evaluation with and without the eta commit;
                        one-stream and two-stream ops     -> B ("cuda" sums
                                                             only against
                                                             "cuda2"/"cuda3"
                                                             with commit), C

The configuration is the bench's (``bench.py``) and the smoke's main path
(``chip_smoke.py`` phase 4): binomial/logit, n=10,000, d=1,000
(``generate_glm_data``, seed 0), IID Normal(0, 1), C=256, the quantile
slice with pseudo-targets adapted in warmup (pseudo_scale 2, pseudo_c 3),
spec_k=4, battery "auto" ("cuda3").  The parts are taken after the smoke's
10 warmup sweeps; A also after the JAX scripts' 5.

  A  the engine's own pass (``FreeRunCGGibbs._block_fn``: the block of 32
     passes its pass loop captures): ``BLOCKS`` blocks chained in one CUDA
     graph, device time per pass (``A_full_pass``); the engine's
     ``run_passes`` over 128 passes on the host clock
     (``A_host_window_ms``); and ``run`` over the smoke's 20 sweeps on the
     host clock less its graph captures, per pass with an active lane, as
     the smoke reports it (``A_host_run_ms``); with f32 and bf16 rows
  B  the bare battery kernel on the pass's own proposals, chained eta ->
     eta: ``battery_gather_commit`` (f32 and bf16 rows), ``battery_commit``
     and ``battery_sums`` (their X^T row gathered once, outside the graph)
  C  a plain 3-stream op of B's footprint: c = a + b over (C, n) float32,
     two reads and a write, the bandwidth floor
  D  the per-pass (C, d) scatters: the row commits
     (``FreeRunCGGibbs._commit_row``) and the draws and evaluation-count
     writes (``_sweep_buffers``)
  E  the prior battery over the (C, K) proposals (``_coord_lp``, the
     quantile pseudo-density and its target, ``_pseudo_target``)
  F  proposal generation: ``ops.freerun_passes.spec_proposals`` less E
  G  the Philox draws: ``_randoms`` for a block of 32 passes, per pass

On the card the engine's pass is the kernel route (``eng.pass_impl`` "cuda",
``ops/freerun_automaton.py``): the block's passes are the automaton kernels
around the battery, named by the ranges ``pass.propose`` P and
``pass.advance`` Q beside ``pass.battery`` B, and the run of
``A_host_window_ms`` reports each kernel's launches by name and per pass
(``launches``).  D-H are then the PyTorch pass's parts, timed alone: what
the kernels replace.

A is taken ``ROUNDS`` times over its three states in turn (f32 rows after
5 and after 10 warmup sweeps, bf16 rows after 10), each time beside the
card's SM clock, power and temperature as nvidia-smi reads them just
after (``A_rounds``): a state's own cost apart from the card's clock.
B to G alone are each timed by CUDA-graph replay: ``PASSES`` calls
captured in one graph, replayed ``REPLAYS`` times between CUDA events, so
no Python wrapper's host cost is in a number; chained, a part alone can
take longer than inside the pass.  Their share of the pass comes from
inside it instead (``in_pass_*``): one block of the engine's pass runs
eagerly under torch.profiler, where the program names the pass's parts
with ranges of its own (``utils.profiling.part``: ``pass.battery`` B,
``pass.scatters`` D, ``pass.prior`` E, ``pass.proposals`` F,
``pass.philox`` G, and ``pass.automaton`` H, each pass's remaining
register updates), which gives each kernel name's split over the parts
(the innermost range counts; the battery kernel, launched from the port's
library and tied to no operator, counts whole to B); the same block,
captured as a CUDA graph, is replayed ``PROFILE_REPLAYS`` times under the
profiler, and each kernel name's device time there is split as in the
eager block.  The in-pass figures are the profiled replays' kernel times
per pass by part; ``other`` is the kernels outside every range (the
block's budget and flag), ``idle`` the replay's span less its busy time.
The remainder is A less the in-pass B, D, E, F, G and H.  The profiled
replays also give the device operations per pass and the top 10
operations by device time.  On the CPU (``--device cpu``) every part runs
eagerly on the host clock, the in-pass figures are the profiler's
operator self times, and nothing is a device number.

    python scripts/torch_pass_budget.py
    python scripts/torch_pass_budget.py --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_automaton as fa  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_passes as fp  # noqa: E402
from torch_study import (  # noqa: E402
    Records,
    card_clocks,
    resolve_device,
    sync,
)

TUNING = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}
WARMUPS = (5, 10)  # the JAX scripts' warmup sweeps, then the smoke's
RUN_SWEEPS = 20  # the smoke's timed run (A_host_run_ms)
WINDOW_PASSES = 128  # A_host_window_ms
REPLAYS = 5
PASSES = 64  # calls per captured graph (B-G alone)
BLOCKS = 2  # blocks of 32 passes per captured graph (A)
PROFILE_REPLAYS = 2
ROUNDS = 2  # A over its three states in turn
# the program's ranges of the pass's parts -> the in-pass figures' names
PART_NAMES = {"pass.battery": "B_battery", "pass.scatters": "D_scatters",
              "pass.prior": "E_prior_battery",
              "pass.proposals": "F_proposal_gen", "pass.philox": "G_philox",
              "pass.automaton": "H_automaton", "pass.propose": "P_propose",
              "pass.advance": "Q_advance"}
# the port's own kernels, launched from its library outside any torch
# operator: name -> part
OWN_KERNELS = {"battery_kernel": "pass.battery",
               "pass_propose_kernel": "pass.propose",
               "pass_advance_kernel": "pass.advance"}


def captured(fn, device):
    """``fn``'s calls captured in one CUDA graph, after a warm-up call on a
    side stream; the graph has been replayed once."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize(device)
    return graph


def part_us(fn, calls, device):
    """Microseconds per call of ``fn``: on CUDA, ``calls`` calls captured in
    one CUDA graph and replayed ``REPLAYS`` times between events; on the
    CPU, ``calls`` eager calls on the host clock."""
    def run():
        for _ in range(calls):
            fn()

    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        run()
        return 1e6 * (time.perf_counter() - t0) / calls
    graph = captured(run, device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPLAYS):
        graph.replay()
    t1.record()
    torch.cuda.synchronize(device)
    return 1e3 * t0.elapsed_time(t1) / (REPLAYS * calls)


class Chain:
    """A tensor an op reads and replaces in place, so that captured calls
    chain on the device (call k+1 reads call k's output)."""

    def __init__(self, t):
        self.t = t

    def step(self, fn):
        self.t.copy_(fn(self.t))


def block_call(eng, st, blocks):
    """A call of ``blocks`` of the engine's own blocks of passes from
    ``st``, chained, every lane active (quota unreached)."""
    C = st.beta.shape[0]
    dev = eng.device
    st = type(st)(*[t.clone() for t in st])  # the kernel route's in place
    block = eng._block_fn(eng._block_passes, False, eng.shrink_only)
    draws, nevbuf = eng._buffers(C, 2)

    def scalar(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    carry0 = (st, torch.zeros(C, dtype=torch.int32, device=dev), draws,
              nevbuf, scalar(1 << 62), scalar(0), scalar(1 << 30), None)

    def run_blocks():
        carry = carry0
        for _ in range(blocks):
            carry, _ = block(eng, carry)
        return carry

    return run_blocks


def full_pass_us(eng, st, blocks):
    """A: device us per pass of ``blocks`` chained blocks in one graph."""
    return part_us(block_call(eng, st, blocks), 1, eng.device) / (
        blocks * eng._block_passes)


def host_window_ms(eng, st, n_passes):
    """The engine's run_passes on the host clock (graph replays with one
    flag read per block), ms per pass, after a call that captures; the
    quota of one sweep (about 1,100 passes at the bench's width) outlasts
    ``n_passes``.  Also the call's kernel launches by name over its
    passes: {name: launches per pass}."""
    eng.run_passes(st, None, None, None, 1, eng._block_passes)
    sync(eng.device)
    fb.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run_passes(st, None, None, None, 1, n_passes)
    sync(eng.device)
    passes = int(out[0].ctr) - int(st.ctr)
    launches = {k: v / passes for k, v in
                {**fa.launch_counts, **fb.launch_counts}.items() if v}
    return 1e3 * (time.perf_counter() - t0) / passes, launches


def host_run_ms(eng, st, n_sweeps):
    """``eng.run`` over ``n_sweeps`` on the host clock less its graph
    captures, ms per pass with an active lane: the smoke's main-path
    figure."""
    cap0, ctr0 = eng.loop_stats["capture_seconds"], int(st.ctr)
    sync(eng.device)
    t0 = time.perf_counter()
    out = eng.run(st, n_sweeps)
    sync(eng.device)
    t = (time.perf_counter() - t0
         - (eng.loop_stats["capture_seconds"] - cap0))
    return 1e3 * t / (int(out[0].ctr) - ctr0)


def tagged_ops(events, cuda):
    """(name, part, us) in launch order: on CUDA each kernel of the
    profiled block, on the CPU each operator's self time; a part is the
    innermost ``pass.*`` range around the launching operator, "other"
    where none is."""
    from torch.autograd import DeviceType

    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    tags = [(e.time_range.start, e.time_range.end, e.thread, e.name)
            for e in cpu if e.name in PART_NAMES]
    out = []
    for e in cpu:
        if e.name in PART_NAMES or (cuda and not e.kernels):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        inside = [t for t in tags
                  if t[0] <= t0 and t1 <= t[1] and t[2] == e.thread]
        part = max(inside)[3] if inside else "other"
        if cuda:
            out += [(k.name, part, k.duration) for k in e.kernels]
        else:
            out.append((e.name, part, e.self_cpu_time_total))
    return out


def in_pass(eng, st):
    """The parts' time inside the engine's own pass (module docstring):
    (us per pass by part, with "other", "busy", "span" and "idle"; the
    timing source; device ops per pass; the top 10 operations by time, us
    per pass; None on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev, B = eng.device, eng._block_passes
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    call = block_call(eng, st, 1)
    call()
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        sync(dev)
        wall = time.perf_counter() - t0
    events = prof.events()
    seq = tagged_ops(events, cuda)
    parts = {k: 0.0 for k in list(PART_NAMES) + ["other"]}
    if not cuda:
        for _, part, us in seq:
            parts[part] += us / B
        parts["busy"] = sum(us for _, _, us in seq) / B
        parts["span"] = 1e6 * wall / B
        parts["idle"] = parts["span"] - parts["busy"]
        return (parts, "host clock, eager: operator self times",
                len(seq) / B, None)
    # each kernel name's split over the parts in the eager block; a name
    # no operator launched (OWN_KERNELS) goes to its part whole
    share = {}
    for name, part, us in seq:
        share.setdefault(name, {}).setdefault(part, 0.0)
        share[name][part] += us
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in share:
            part = next((p for k, p in OWN_KERNELS.items() if k in e.name),
                        "other")
            share[e.name] = {part: 1.0}
    graph = captured(call, dev)
    with profile(activities=acts) as prof:
        for _ in range(PROFILE_REPLAYS):
            graph.replay()
        sync(dev)
    ker = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    by_name = {}
    for e in ker:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in by_name.items():
        split = share.get(name, {"other": 1.0})
        total = sum(split.values())
        for part, v in split.items():
            parts[part] += us * v / total / (PROFILE_REPLAYS * B)
    parts["busy"] = sum(by_name.values()) / (PROFILE_REPLAYS * B)
    n = len(ker) // PROFILE_REPLAYS
    if n * PROFILE_REPLAYS == len(ker):
        parts["span"] = sum(
            ker[(r + 1) * n - 1].time_range.end - ker[r * n].time_range.start
            for r in range(PROFILE_REPLAYS)) / (PROFILE_REPLAYS * B)
        parts["idle"] = parts["span"] - parts["busy"]
    top = [[k[:80], v / (PROFILE_REPLAYS * B)] for k, v in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    source = ("cuda graph replay under torch.profiler, each kernel name's "
              "time split over the parts as in an eager block")
    return parts, source, len(ker) / (PROFILE_REPLAYS * B), top


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="n=2,000, d=100, C=8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    n, d, C = (2_000, 100, 8) if args.small else (10_000, 1_000, 256)
    P = 4 if args.small else PASSES
    blocks = 1 if args.small else BLOCKS
    run_sweeps = 2 if args.small else RUN_SWEEPS
    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), d)
    rec = Records("pass_budget", device, args.out)
    kw = dict(tuning=TUNING, slice_kernel="quantile", spec_k=4,
              device=device)
    eng = mt.FreeRunCGGibbs(X, y, "binomial", prior, **kw)
    e16 = mt.FreeRunCGGibbs(X, y, "binomial", prior, x_storage="bf16", **kw)
    # A's states: name -> (engine, state after its warmup)
    arms = {f"f32_warmup{w}": (eng, eng.warmup(eng.init(0, C), w)[0])
            for w in WARMUPS[:-1]}
    arms["f32"] = (eng, eng.warmup(eng.init(0, C), WARMUPS[-1])[0])
    arms["bf16"] = (e16, e16.warmup(e16.init(0, C), WARMUPS[-1])[0])
    st = arms["f32"][1]
    rounds = []
    for r in range(ROUNDS):
        for name, (e, s_) in arms.items():
            rounds.append({"round": r, "state": name,
                           "us": full_pass_us(e, s_, blocks),
                           "card_after": card_clocks(device)})
    parts, launches = {}, {}
    for name, (e, s_) in arms.items():
        parts[f"A_full_pass_{name}"] = statistics.median(
            x["us"] for x in rounds if x["state"] == name)
        parts[f"A_host_window_ms_{name}"], launches[name] = host_window_ms(
            e, s_, WINDOW_PASSES)

    # the pass's own inputs at the warm state
    K = eng.spec_k
    U = eng._randoms(st.key, st.ctr, 1, C)["u"][0]
    p = fp.spec_proposals(eng, st, U[:, :K])
    rem = torch.clamp(eng.max_shrink - st.n_shrink, min=0)
    scal = torch.stack([st.level, st.ld0, (st.phase == 1).to(eng.dtype),
                        rem.to(eng.dtype)], 1)
    fam, ex, m = eng.family, eng._extra_host, eng._mask
    xg = eng.Xt[st.j.long()]
    xt16 = eng.Xt.to(torch.bfloat16)
    eta = Chain(st.eta.clone())
    kernels = {
        "battery_gather_commit": lambda e: fb.battery_gather_commit(
            st.j, eng.Xt, e, p["deltas"], p["fprior"], scal, eng.y, m, fam,
            ex)[1],
        "battery_gather_commit_bf16": lambda e: fb.battery_gather_commit(
            st.j, xt16, e, p["deltas"], p["fprior"], scal, eng.y, m, fam,
            ex)[1],
        "battery_commit": lambda e: fb.battery_commit(
            e, xg, p["deltas"], p["fprior"], scal, eng.y, m, fam, ex)[1],
    }
    for name, fn in kernels.items():
        parts[f"B_{name}"] = part_us(lambda fn=fn: eta.step(fn), P, device)
    parts["B_battery_sums"] = part_us(
        lambda: fb.battery_sums(eta.t, xg, p["deltas"], eng.y, m, fam, ex),
        P, device)

    a, b = st.eta.clone(), xg.clone()
    c = torch.empty_like(a)
    parts["C_3stream_floor"] = part_us(lambda: torch.add(a, b, out=c), P,
                                       device)

    beta, sc = Chain(st.beta.clone()), torch.zeros(C, dtype=torch.int32,
                                                   device=device)
    draws, nevbuf = eng._buffers(C, 2)
    done = st.j == 0

    def scatters():
        beta.step(lambda t: eng._commit_row(t, st.j, st.b0 + 1e-6))
        eng._sweep_buffers(draws, nevbuf, sc, beta.t, st.nev, done)

    parts["D_scatters"] = part_us(scatters, P, device)

    def prior_battery():
        q_loc, q_scale, _ = fp._pseudo_target(eng, st)
        xs = p["xs_eval"]
        fprior = eng._coord_lp(st.beta, st.j, xs) - st.lp0[:, None]
        return fprior + (eng.quantile_logpdf(st.b0, q_loc, q_scale)[:, None]
                         - eng.quantile_logpdf(xs, q_loc[:, None],
                                               q_scale[:, None]))

    parts["E_prior_battery"] = part_us(prior_battery, P, device)
    parts["EF_spec_proposals"] = part_us(
        lambda: fp.spec_proposals(eng, st, U[:, :K]), P, device)
    parts["F_proposal_gen"] = parts["EF_spec_proposals"] - parts[
        "E_prior_battery"]
    B = eng._block_passes
    parts["G_philox"] = part_us(
        lambda: eng._randoms(st.key, st.ctr, B, C), 1 if args.small else 8,
        device) / B

    inside, source, ops, top = in_pass(eng, st)
    for k, v in inside.items():
        parts[f"in_pass_{PART_NAMES.get(k, k)}"] = v
    named = [f"in_pass_{v}" for v in PART_NAMES.values()]
    parts["remainder"] = parts["A_full_pass_f32"] - sum(parts[k]
                                                        for k in named)
    # last: the smoke's own protocol, which advances the chains
    for name, (e, s_) in arms.items():
        parts[f"A_host_run_ms_{name}"] = host_run_ms(e, s_, run_sweeps)
    for k, v in parts.items():
        unit = "ms" if "_ms_" in k else "us"
        print(f"{k:34s} {v:10.3f} {unit} per pass", flush=True)
    prof = ({"device_ops_per_pass": ops, "top10_us_per_pass": top}
            if top is not None else "not measured")
    print(f"pass_impl {eng.pass_impl!r} ({eng.pass_impl_reason}); "
          f"launches per pass {launches}", flush=True)
    rec.write({"n": n, "d": d, "chains": C, "spec_k": K,
               "battery": eng.battery_impl, "pass_impl": eng.pass_impl,
               "launches_per_pass": launches, "warmup": WARMUPS[-1],
               "warmups_of_A": list(WARMUPS), "run_sweeps": run_sweeps,
               "calls_per_graph": P, "timing": "cuda graph replay"
               if device.type == "cuda" else "host clock, eager",
               "in_pass_timing": source, "A_rounds": rounds,
               "us_per_pass": parts,
               "remainder_of": ["A_full_pass_f32"] + named,
               "profile": prof})
    if top is not None:
        print(f"device ops per pass {ops:.1f} ({source}); top 10:",
              flush=True)
        for name, us in top:
            print(f"  {us:8.2f} us  {name}", flush=True)


if __name__ == "__main__":
    main()
