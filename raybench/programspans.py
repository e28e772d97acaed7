#!/usr/bin/env python3
"""The program's own spans and counters (``hare_tpu_torch.utils.tracing``)
in one profiled run of a cell: set-up split by phase, the host's time a
step inside the program and inside its blocking reads, and the device's
idle time charged to the program span that held the launch.

    python3 raybench/programspans.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on a card.  It turns the program's recording
on before set-up, then runs the cell's set-up and a profiled window as a
``--trace 1`` run of ``run.py`` does, without the check of the outputs.
Standard error gets one line per span (set-up spans in seconds; the
window's in calls, host self ms and device-idle ms charged to it, a step),
each counter a step and each kernel name a step; the last line of standard
output is one JSON object of the readings.

These readings are not metrics of ``BENCHMARK.json``: ``run.py`` does not
turn the program's recording on and ``harness.run`` hands the readers no
program spans.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from raybench import cells, devtrace, harness  # noqa: E402

# The program's own spans (hare_tpu_torch.utils.tracing, recorded while its
# tracing is on): each lands in the profiler's trace as a host event of its
# name.  hare.sync holds a read that blocks the host on the device.
PROGRAM, PROGRAM_SYNC = "hare.", "hare.sync"


class ProgramSpan(NamedTuple):
    name: str
    start: int  # ns, the profiler's clock
    end: int
    thread: int  # the profiler's id of the thread it ran on


class ProgramTrace(NamedTuple):
    spans: List[ProgramSpan]  # the program's spans in the window, by start
    # The device's idle gaps in the window: (start, end, launch, thread),
    # where launch is when the operation that ends the gap was launched and
    # thread the thread that launched it (None where not found).
    gaps: List[Tuple[int, int, Optional[int], Optional[int]]]
    steps: int
    window: Tuple[int, int]


def program(prof, tr: devtrace.DevTrace) -> ProgramTrace:
    """The program's spans (``hare.*``) from a finished profile read by
    :func:`devtrace.collect`, with their threads, and the device's idle gaps in the
    window, each with the launch of the operation that ends it.  A program
    that records no spans gives none."""
    cuda = torch.autograd.DeviceType.CUDA
    w0, w1 = tr.window
    spans, launch, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name not in devtrace.SPANS:  # as devtrace.collect reads them
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                            e.linked_correlation_id()))
        elif name.startswith(PROGRAM):
            if e.end_ns() >= w0 and e.start_ns() <= w1:
                spans.append(ProgramSpan(name, e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    gaps, prev_end = [], w0
    for s, e, corr, linked in sorted(op for op in ops if w0 <= op[0] <= w1):
        if s > prev_end:
            gaps.append((prev_end, s) + launch.get(corr, launch.get(linked, (None, None))))
        prev_end = max(prev_end, e)
    spans.sort(key=lambda x: (x.start, -x.end))
    return ProgramTrace(spans, gaps, tr.steps, tr.window)


def _union_ns(spans) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((x.start, x.end) for x in spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def _by_thread(spans) -> Dict[int, List[ProgramSpan]]:
    out: Dict[int, List[ProgramSpan]] = defaultdict(list)
    for x in spans:
        out[x.thread].append(x)
    return out


def program_host_ms(pt: ProgramTrace) -> Optional[Tuple[float, float]]:
    """Host ms a step in the program's code, less its blocking reads, and
    host ms a step in those reads (``hare.sync``): on each thread the union
    of its program spans, those of the reads apart, summed over threads.
    None where the program recorded no span."""
    if not pt.spans:
        return None
    inside = sync = 0
    for spans in _by_thread(pt.spans).values():
        reads = _union_ns(x for x in spans if x.name == PROGRAM_SYNC)
        inside += _union_ns(spans) - reads
        sync += reads
    return inside / 1e6 / pt.steps, sync / 1e6 / pt.steps


def _innermost(spans) -> List[Tuple[int, int, str]]:
    """One thread's nested spans, by start, cut into (start, end, name) of
    the innermost span at each moment."""
    segs, stack, cur = [], [], 0
    for x in spans:
        while stack and stack[-1][0] <= x.start:
            end, name = stack.pop()
            if end > cur:
                segs.append((cur, end, name))
                cur = end
        if stack and x.start > cur:
            segs.append((cur, x.start, stack[-1][1]))
        stack.append((x.end, x.name))
        cur = x.start
    while stack:
        end, name = stack.pop()
        if end > cur:
            segs.append((cur, end, name))
            cur = end
    return segs


def idle_charged_ns(pt: ProgramTrace) -> Dict[str, int]:
    """Nanoseconds of the device's idle gaps charged to each program span:
    each moment of a gap goes to the innermost span (``hare.sync`` aside)
    that the thread which launched the gap's closing operation was in."""
    segs = {t: _innermost([x for x in s if x.name != PROGRAM_SYNC])
            for t, s in _by_thread(pt.spans).items()}
    starts = {t: [s for s, _, _ in v] for t, v in segs.items()}
    out: Dict[str, int] = defaultdict(int)
    for g0, g1, _, thread in pt.gaps:
        if thread not in segs:
            continue
        seg = segs[thread]
        i = max(bisect.bisect_right(starts[thread], g0) - 1, 0)
        while i < len(seg) and seg[i][0] < g1:
            s, e, name = seg[i]
            if min(e, g1) > max(s, g0):
                out[name] += min(e, g1) - max(s, g0)
            i += 1
    return dict(out)


def table(pt: Optional[ProgramTrace], setup=None, window=None) -> List[str]:
    """Lines for the report: each set-up span of the snapshot ``setup``
    (calls, seconds, self seconds); each program span of the window (calls
    a step, host self ms a step, device-idle ms a step charged to it); each
    counter of the snapshot ``window`` a step."""
    lines = []
    if setup is not None:
        kids = defaultdict(int)
        for x in setup.spans:
            if x.parent is not None:
                kids[x.parent] += x.end_ns - x.start_ns
        rows: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
        for x in setup.spans:
            r = rows[x.name]
            r[0] += 1
            r[1] += (x.end_ns - x.start_ns) / 1e9
            r[2] += (x.end_ns - x.start_ns - kids[x.seq]) / 1e9
        for name, (n, s, own) in sorted(rows.items()):
            lines.append(f"program set-up span {name}: {n} calls, {s:.6f} s, self {own:.6f} s")
    if pt is not None and pt.spans:
        calls: Dict[str, int] = defaultdict(int)
        own: Dict[str, int] = defaultdict(int)
        for t, spans in _by_thread(pt.spans).items():
            for x in spans:
                calls[x.name] += 1
            for s, e, name in _innermost(spans):
                own[name] += e - s
        idle = idle_charged_ns(pt)
        for name in sorted(calls):
            lines.append(f"program span {name}: {calls[name] / pt.steps:.3f} calls a step, host "
                         f"self {own[name] / 1e6 / pt.steps:.4f} ms a step, device idle "
                         f"{idle.get(name, 0) / 1e6 / pt.steps:.4f} ms a step charged to it")
    if window is not None and pt is not None and pt.steps:
        for name, n in sorted(window.counters.items()):
            lines.append(f"program counter {name}: {n / pt.steps:.3f} a step")
    return lines


def kernel_counts(tr: devtrace.DevTrace) -> Dict[str, float]:
    """Kernels a step by short name: what the program's launch counters are
    held against (an entry point may launch several kernels a call)."""
    out: Dict[str, float] = defaultdict(float)
    for op in tr.kernels:
        out[devtrace.short(op.name)] += 1 / tr.steps
    return dict(out)


# Set-up's phases as the program names them: a reading each, in seconds.
SETUP = {"setup.topology_s": "hare.setup.topology", "setup.scene_s": "hare.setup.scene",
         "setup.structure_s": "hare.setup.structure"}


def readings(setup, pt: Optional[ProgramTrace]) -> Dict[str, Optional[float]]:
    """The readings of a run, each None where nothing was recorded for it:
    the set-up phases' seconds from the snapshot ``setup``; from the
    window's spans ``pt``, the program's host ms a step less its blocking
    reads (``host.dispatch_ms``), the ms a step in those reads
    (``host.sync_wait_ms``) and the share of the window the device was idle
    while a program span held the launch (``device.idle_program_pct``)."""
    out: Dict[str, Optional[float]] = {}
    for key, name in SETUP.items():
        ns = [x.end_ns - x.start_ns for x in (setup.spans if setup else ()) if x.name == name]
        out[key] = sum(ns) / 1e9 if ns else None
    host = program_host_ms(pt) if pt is not None else None
    out["host.dispatch_ms"], out["host.sync_wait_ms"] = host or (None, None)
    idle = None
    if pt is not None and pt.spans and pt.gaps and pt.window[1] > pt.window[0]:
        idle = 100.0 * sum(idle_charged_ns(pt).values()) / (pt.window[1] - pt.window[0])
    out["device.idle_program_pct"] = idle
    return out


def run(cell: cells.Cell, seed: int, seconds: float, device, t_start: float,
        report=sys.stderr) -> Dict:
    """Set-up and a profiled window of ``cell`` with the program's
    recording on; the readings, the run's set-up seconds, the device's idle
    share, the trace's blocking calls a step and each counter a step."""
    from hare_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    try:
        s = harness.set_up(cell, seed, device)
        setup_s = time.time() - t_start
        setup = tracing.snapshot()
        tracing.reset()
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            harness.window(s, min(seconds, harness.TRACE_SECONDS), device)
        window = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    tr = devtrace.collect(prof)
    pt = program(prof, tr)
    for line in table(pt, setup, window):
        print(line, file=report)
    for name, n in sorted(kernel_counts(tr).items()):
        print(f"device kernel {name}: {n:.3f} a step", file=report)
    span = tr.window[1] - tr.window[0]
    out = dict(readings(setup, pt), setup_s=setup_s, steps=tr.steps,
               idle_pct=100.0 * (1.0 - devtrace.busy_ns(tr) / span) if span > 0 else None,
               # as host.syncs_per_step reads it: less the step's closing synchronise
               syncs_per_step=tr.syncs / tr.steps - 1,
               counters={k: v / tr.steps for k, v in sorted(window.counters.items())})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=harness.TRACE_SECONDS)
    args = p.parse_args(argv)
    t_start = harness.process_start()
    cell = cells.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, "cuda", t_start)
    print(json.dumps(dict(out, workload=cell.name, seed=args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
