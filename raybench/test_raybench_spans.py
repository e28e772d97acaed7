"""``programspans``, the reader of the program's own spans: the set-up
split, the host's time in the program and in its blocking reads, and the
device's idle time charged to program code, on synthetic spans and
profiler events, on a CPU run at a tiny size, and with no program spans
(every reading None); and the benchmark's own traced run, which leaves the
program's recording off."""

import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raybench import cells, devtrace, harness, programspans  # noqa: E402
from raybench.programspans import ProgramSpan, ProgramTrace  # noqa: E402

READINGS = ("setup.topology_s", "setup.scene_s", "setup.structure_s", "host.dispatch_ms",
            "host.sync_wait_ms", "device.idle_program_pct")
MS = 1_000_000  # ns


def setup_snapshot():
    """Set-up's spans as utils.tracing records them: seconds 3 (topology,
    1 of it welding), 0.5 (scene), 2 (structure)."""
    from hare_tpu_torch.utils.tracing import Snapshot, Span

    s = 1_000_000_000
    return Snapshot([
        Span(1, "hare.setup.topology", {"id": 1}, None, 7, 0, 3 * s),
        Span(2, "hare.setup.topology.weld", {"id": 1}, 1, 7, 0, 1 * s),
        Span(3, "hare.setup.scene", {"id": 3}, None, 7, 3 * s, 3 * s + s // 2),
        Span(4, "hare.setup.structure", {"accel": "grid", "id": 4}, None, 7, 4 * s, 6 * s),
    ], {"kernels.builds": 1})


def two_step_trace():
    """Two steps of 10 ms on the main thread (1) and autograd's (2).

    Main: hare.trace_rays 0-6 holding hare.bounce 1-5, which holds
    hare.shoot 1-3 with a hare.sync 2-3; hare.histogram 6-7.  Autograd:
    hare.backward.bounce_step 8-9.  Step 2 the same, 10 ms on.  Device idle
    gaps: 0-2 (closed by an op launched at 1.5 on thread 1), 3-4 (launched
    at 3.5 on 1), 7.5-9 (launched at 8.5 on 2), 9.5-10 (no launch found).
    """
    spans, gaps = [], []
    for k in (0, 10):
        t = lambda ms: (k + ms) * MS  # noqa: E731
        spans += [ProgramSpan("hare.trace_rays", t(0), t(6), 1),
                  ProgramSpan("hare.bounce", t(1), t(5), 1),
                  ProgramSpan("hare.shoot", t(1), t(3), 1),
                  ProgramSpan("hare.sync", t(2), t(3), 1),
                  ProgramSpan("hare.histogram", t(6), t(7), 1),
                  ProgramSpan("hare.backward.bounce_step", t(8), t(9), 2)]
        gaps += [(t(0), t(2), t(1.5), 1), (t(3), t(4), t(3.5), 1), (t(7.5), t(9), t(8.5), 2),
                 (t(9.5), t(10), None, None)]
    spans.sort(key=lambda x: (x.start, -x.end))
    return ProgramTrace(spans, gaps, 2, (0, 20 * MS))


def test_host_ms_splits_program_time_from_blocking_reads():
    # A step: main 0-7 less the read 2-3, 6 ms; autograd 8-9, 1 ms.
    assert programspans.program_host_ms(two_step_trace()) == (7.0, 1.0)
    got = programspans.readings(None, two_step_trace())
    assert got["host.dispatch_ms"] == 7.0 and got["host.sync_wait_ms"] == 1.0


def test_innermost_cuts_nested_spans():
    spans = [x for x in two_step_trace().spans if x.thread == 1 and x.start < 10 * MS]
    assert programspans._innermost(spans) == [
        (0, 1 * MS, "hare.trace_rays"), (1 * MS, 2 * MS, "hare.shoot"),
        (2 * MS, 3 * MS, "hare.sync"), (3 * MS, 5 * MS, "hare.bounce"),
        (5 * MS, 6 * MS, "hare.trace_rays"), (6 * MS, 7 * MS, "hare.histogram")]


def test_idle_is_charged_to_the_launching_threads_innermost_span():
    """Gap 0-2: 0-1 hare.trace_rays, 1-2 hare.shoot; gap 3-4: hare.bounce
    (the read ended at 3); gap 7.5-9 on autograd's thread: 8-9 to its
    backward span; the gap with no launch found is not charged."""
    got = programspans.idle_charged_ns(two_step_trace())
    assert got == {"hare.trace_rays": 2 * MS, "hare.shoot": 2 * MS, "hare.bounce": 2 * MS,
                   "hare.backward.bounce_step": 2 * MS}
    # 4 ms a step of 10: 40% of the window.
    assert programspans.readings(None, two_step_trace())["device.idle_program_pct"] == 40.0


def test_a_read_is_charged_to_the_span_around_it():
    """A gap while the thread was in hare.sync goes to the span holding
    the read."""
    pt = ProgramTrace([ProgramSpan("hare.traverse", 0, 10, 1), ProgramSpan("hare.sync", 2, 8, 1)],
                      [(4, 6, 9, 1)], 1, (0, 10))
    assert programspans.idle_charged_ns(pt) == {"hare.traverse": 2}


def test_setup_readings():
    got = programspans.readings(setup_snapshot(), None)
    assert got["setup.topology_s"] == 3.0
    assert got["setup.scene_s"] == 0.5
    assert got["setup.structure_s"] == 2.0


def test_table_lines():
    from hare_tpu_torch.utils.tracing import Snapshot

    window = Snapshot([], {"launches.hare_tree_shoot": 16, "syncs.tree_flag": 16})
    lines = programspans.table(two_step_trace(), setup_snapshot(), window)
    assert "program set-up span hare.setup.topology: 1 calls, 3.000000 s, self 2.000000 s" in lines
    assert ("program span hare.shoot: 1.000 calls a step, host self 1.0000 ms a step, device "
            "idle 1.0000 ms a step charged to it") in lines
    assert "program counter syncs.tree_flag: 8.000 a step" in lines


class _Event:
    def __init__(self, name, start, end, cuda=False, corr=0, linked=0, thread=1):
        self._v = (name, start, end, cuda, corr, linked, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_program_reads_spans_and_gaps_from_profiler_events():
    """The program's host events with their threads; the device's
    operations make the gaps, each with the launch (time, thread) of the
    operation that ends it."""
    events = [
        _Event("raybench.step", 0, 100), _Event("raybench.step", 0, 100, cuda=True),
        _Event("hare.trace_rays", 5, 60, thread=1),
        _Event("hare.backward.scatter", 70, 80, thread=2),
        _Event("cudaLaunchKernel", 10, 12, corr=1, thread=1),
        _Event("cudaLaunchKernel", 72, 74, corr=2, thread=2),
        _Event("k1", 20, 40, cuda=True, corr=1), _Event("k2", 75, 90, cuda=True, corr=2),
        _Event("Memcpy DtoH", 92, 95, cuda=True, corr=9),
    ]
    tr = devtrace.collect(_prof(events))
    assert [op.name for op in tr.kernels] == ["k1", "k2"] and tr.window == (0, 100)
    pt = programspans.program(_prof(events), tr)
    assert pt.spans == [ProgramSpan("hare.trace_rays", 5, 60, 1),
                        ProgramSpan("hare.backward.scatter", 70, 80, 2)]
    assert pt.gaps == [(0, 20, 10, 1), (40, 75, 72, 2), (90, 92, None, None)]
    assert pt.steps == 1
    # 0-20: 5-20 in hare.trace_rays; 40-75: 70-75 in autograd's span.
    assert programspans.idle_charged_ns(pt) == {"hare.trace_rays": 15, "hare.backward.scatter": 5}


def test_no_program_spans_reads_none():
    """Nothing recorded: every reading None, with or without a trace."""
    empty = ProgramTrace([], [(0, 5, 1, 1)], 3, (0, 10))
    from hare_tpu_torch.utils.tracing import Snapshot

    for setup, pt in ((None, None), (Snapshot([], {}), empty)):
        got = programspans.readings(setup, pt)
        assert sorted(got) == sorted(READINGS)
        assert all(v is None for v in got.values()), got


def tiny(name="c3_octree_32k_fwdbwd"):
    cell = cells.resolve(name, ROOT)
    return cell._replace(traffic=dict(cell.traffic, rays_per_step=128, pool_batches=1, bounces=2),
                         config=dict(cell.config, check_rays=64))


def test_cpu_run_reads_the_program():
    """A run on the CPU at a tiny size: the set-up split and the host's
    program time are read (the CPU has no device, so nothing is charged to
    idle), each bounce's rays counted, and recording is off after it."""
    from hare_tpu_torch.utils import tracing

    cell = tiny()
    with open(os.devnull, "w") as devnull:
        r = programspans.run(cell, 2**31 + 7, 0.2, "cpu", time.time(), report=devnull)
    assert not tracing.enabled() and not tracing.snapshot().spans
    for name in ("setup.topology_s", "setup.scene_s", "setup.structure_s"):
        assert 0 < r[name] < r["setup_s"]
    assert r["host.dispatch_ms"] > 0
    assert r["host.sync_wait_ms"] == 0.0
    assert r["device.idle_program_pct"] is None  # the CPU has no idle gaps to charge
    assert r["counters"]["rays.shot"] == 128 * 2


def test_benchmark_run_leaves_the_program_unrecorded():
    """The benchmark's own traced run does not turn the program's recording
    on: no program span is kept and its metrics read what they read."""
    from hare_tpu_torch.utils import tracing

    tracing.reset()
    with open(os.devnull, "w") as devnull:
        r = harness.run(tiny(), 2**31 + 7, 0.2, True, "cpu", time.time(), report=devnull)
    assert r["correct"] is True
    assert not tracing.enabled() and not tracing.snapshot().spans
    assert not any(k.startswith(READINGS) for k in r["metrics"])
