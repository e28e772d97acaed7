"""The traced run's reading of torch.profiler: the device's kernels and
copies, the host's CUDA runtime calls, and the harness's own spans around
each layer (``raybench.step``, ``raybench.forward``, ``raybench.backward``),
all on the profiler's one clock.

A kernel belongs to the span whose host interval holds the runtime call
that launched it (matched by the profiler's correlation id), whichever
thread launched it: the backward's kernels are launched by autograd's
device thread while the main thread waits inside ``raybench.backward``.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

STEP, FORWARD, BACKWARD = "raybench.step", "raybench.forward", "raybench.backward"
SPANS = (STEP, FORWARD, BACKWARD)
# Runtime calls that block the host until the device has caught up.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


class Op(NamedTuple):
    name: str
    start: int  # ns, the profiler's clock
    end: int
    span: str  # the harness span that launched it ("" for none found)


class DevTrace(NamedTuple):
    kernels: List[Op]
    copies: List[Op]  # memcpy and memset on the device
    syncs: int  # blocking runtime calls inside the window
    steps: int
    window: Tuple[int, int]
    linked: float  # share of kernels matched to their launch


def short(name: str) -> str:
    """A kernel's name without ``void``, namespaces and parameter list."""
    s = name.replace("void ", "").replace("(anonymous namespace)::", "")
    s = s.replace("at::native::", "")
    depth, out = 0, []
    for ch in s:  # cut the parameter list: the first '(' outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    s = re.sub(r"\s+", " ", "".join(out)).strip()
    return s[:60]


def collect(prof) -> DevTrace:
    """Read a finished ``torch.profiler.profile`` of whole steps."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    launch: Dict[int, int] = {}
    runtime: List[Tuple[str, int]] = []
    device: List[Tuple[str, int, int, int, int]] = []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name not in SPANS:  # the device-side copies of the spans
                device.append((name, e.start_ns(), e.end_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
        elif name in SPANS:
            spans[name].append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
            runtime.append((name, e.start_ns()))
    steps = sorted(spans[STEP])
    if not steps:
        raise RuntimeError("the trace holds no raybench.step span")
    window = (steps[0][0], steps[-1][1])
    layer = sorted((s, e, k) for k in (FORWARD, BACKWARD) for s, e in spans[k])
    starts = [s for s, _, _ in layer]

    def span_of(t: Optional[int]) -> str:
        if t is None:
            return ""
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and layer[i][0] <= t <= layer[i][1]:
            return layer[i][2]
        return ""

    kernels, copies, linked = [], [], 0
    for name, s, e, corr, linked_corr in device:
        if not (window[0] <= s <= window[1]):
            continue
        t = launch.get(corr, launch.get(linked_corr))
        op = Op(name, s, e, span_of(t))
        if name.startswith(("Memcpy", "Memset")):
            copies.append(op)
        else:
            kernels.append(op)
            linked += t is not None
    syncs = sum(1 for name, t in runtime if name in SYNC_CALLS and window[0] <= t <= window[1])
    return DevTrace(kernels, copies, syncs, len(steps), window,
                    linked / len(kernels) if kernels else 0.0)


def collect_device(prof, steps: int) -> DevTrace:
    """Read a finished ``torch.profiler.profile`` of the device's activity
    alone over ``steps`` whole steps: every kernel, copy and memset it
    holds, the window from the first one's start to the last one's end."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cuda or name in SPANS:
            continue
        op = Op(name, e.start_ns(), e.end_ns(), "")
        (copies if name.startswith(("Memcpy", "Memset")) else kernels).append(op)
    ops = kernels + copies
    window = (min(o.start for o in ops), max(o.end for o in ops)) if ops else (0, 0)
    return DevTrace(kernels, copies, 0, steps, window, 0.0)


def busy_ns(tr: DevTrace) -> int:
    """Nanoseconds of the window in which some kernel or copy ran."""
    total, cur_s, cur_e = 0, None, None
    for op in sorted(tr.kernels + tr.copies, key=lambda o: o.start):
        s, e = max(op.start, tr.window[0]), min(op.end, tr.window[1])
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_ms(tr: DevTrace, include=(), span: Optional[str] = None, exclude=()) -> float:
    """Device milliseconds a step of the kernels whose names hold one of
    ``include`` (all where empty) and none of ``exclude``, launched in
    ``span`` (any where None)."""
    ns = sum(op.end - op.start for op in tr.kernels
             if (not include or any(p in op.name for p in include))
             and not any(p in op.name for p in exclude)
             and (span is None or op.span == span))
    return ns / 1e6 / tr.steps


def breakdown(tr: DevTrace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps summed
    by where they fall: the host span and the device operations before and
    after the gap."""
    by_op: Dict[str, int] = defaultdict(int)
    for op in tr.kernels + tr.copies:
        by_op[short(op.name)] += op.end - op.start
    ops = sorted(tr.kernels + tr.copies, key=lambda o: o.start)
    gaps: Dict[str, int] = defaultdict(int)
    counts: Dict[str, int] = defaultdict(int)
    prev_end, prev = tr.window[0], "step start"
    for op in ops + [Op("step end", tr.window[1], tr.window[1], "")]:
        if op.start > prev_end:
            label = f"{op.span or 'between steps'}: {prev} -> {short(op.name)}"
            gaps[label] += op.start - prev_end
            counts[label] += 1
        if op.end > prev_end:
            prev_end, prev = op.end, short(op.name)
    return {
        "device_ops": [[k, v / 1e9] for k, v in sorted(by_op.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[f"{k} (x{counts[k]})", v / 1e9]
                      for k, v in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
    }
