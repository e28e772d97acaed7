"""The harness on the CPU at tiny sizes: a new cell from new files alone,
the import boundary, no result without a card, and the check's verdicts:
sound runs pass, the control and the planted faults fail."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raybench import cells, harness, judge, program  # noqa: E402

TINY_HALL = {"rays_per_step": 384, "pool_batches": 2}


def _tiny(cell_name: str, **traffic):
    cell = cells.resolve(cell_name, ROOT)
    return cell._replace(traffic=dict(cell.traffic, **TINY_HALL, **traffic),
                         config=dict(cell.config, check_rays=384))


def _new_files(tmp_path: Path) -> Path:
    """A copy of the benchmark with a configuration, a traffic mix, a
    metric, limits and a cell added as files, and BENCHMARK.json naming
    them."""
    root = tmp_path / "tree"
    shutil.copytree(ROOT / "raybench", root / "raybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "raybench/configs/box_sphere_grid.json").write_text(json.dumps({
        "name": "box_sphere_grid", "scene": [
            {"shape": "shoebox", "args": {"lx": 20.0, "ly": 20.0, "lz": 20.0}},
            {"shape": "icosphere", "args": {"subdiv": 2, "radius": 5.0,
                                            "center": [10.0, 10.0, 10.0]}}],
        "n_triangles": 332, "accel": "grid", "accel_params": {"domain": 8},
        "kernel": "watertight", "dtype": "float32", "source": [3.0, 4.0, 5.0],
        "absorption": 0.2, "sound_speed": 343.0, "check_rays": 256, "reduced": []}))
    (root / "raybench/traffic/rays256_b2.json").write_text(json.dumps({
        "rays_per_step": 256, "bounces": 2, "bins": 64, "bin_dt": 0.002,
        "pool_batches": 2}))
    (root / "raybench/metrics/steps_done.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx.steps)
    '''))
    (root / "raybench/limits/box_sphere_small.json").write_text(
        (ROOT / "raybench/limits/c3_octree_32k_fwdbwd.json").read_text())
    bench["configs"].append({"name": "box_sphere_grid", "source": "test",
                             "file": "raybench/configs/box_sphere_grid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "box_sphere_small", "config": "box_sphere_grid",
                               "traffic": "rays256_b2", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["box_sphere_small"]})
    # A metric split by family, read by the reader of the name it splits.
    bench["end_to_end"].append({"name": "mrays_s.tiny", "unit": "Mrays/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["box_sphere_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_new_cell_from_files_alone(tmp_path):
    root = _new_files(tmp_path)
    cell = cells.resolve("box_sphere_small", root, root / "raybench")
    assert cell.config["accel"] == "grid" and cell.traffic["bounces"] == 2
    assert [m.name for m in cell.end_to_end] == ["setup_s", "steps_done", "mrays_s.tiny"]
    r = harness.run(cell, 2**31 + 99, 0.2, False, "cpu", time.time(), report=open(os.devnull, "w"))
    assert r["correct"] is True
    assert r["metrics"]["steps_done"]["value"] == r["attempted"] >= 1
    rate = 256 * 2 * r["attempted"] / r["metrics"]["mrays_s.tiny"]["value"] / 1e6
    assert 0.2 <= rate < 60  # the window's seconds
    assert r["setup_built_kernels"] is False
    assert list(r)[-1] == "checks"


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "raybench/run.py", "--workload", "c3_octree_32k_fwdbwd",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_import_boundary():
    """Everything a run loads, by top-level name: no JAX, no hare_tpu, no
    benchmarks; the reference and the judge load nothing of hare_tpu_torch."""
    code = textwrap.dedent(f'''
        import sys, time, json, os
        sys.path.insert(0, {str(ROOT)!r})
        from raybench import judge, reference, rays, shapes, counts
        ref = sorted({{m.split(".")[0] for m in sys.modules}})
        from raybench import cells, harness
        c = cells.resolve("c3_octree_32k_fwdbwd")
        c = c._replace(traffic=dict(c.traffic, rays_per_step=128, pool_batches=1, bounces=2),
                       config=dict(c.config, check_rays=64))
        harness.run(c, 5, 0.1, True, "cpu", time.time(), report=open(os.devnull, "w"))
        for n in ("cells", "harness", "program", "devtrace", "run"):
            __import__("raybench." + n)
        print(json.dumps([ref, sorted({{m.split(".")[0] for m in sys.modules}}),
                          harness.forbidden_modules()]))
    ''')
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-2000:]
    ref, run, bad = json.loads(p.stdout.strip().splitlines()[-1])
    assert "hare_tpu_torch" not in ref
    assert "hare_tpu_torch" in run
    for name in ("jax", "jaxlib", "flax", "hare_tpu", "benchmarks"):
        assert name not in run
    assert bad == []


def test_sound_runs_pass_the_cells_limits():
    for name in ("c3_octree_32k_fwdbwd", "c3_octree_1m_fwdbwd"):
        cell = _tiny(name, bounces=3)
        r = harness.run(cell, 2**32 + 3, 0.1, False, "cpu", time.time(),
                        report=open(os.devnull, "w"))
        assert r["correct"] is True, r["checks"]


def test_control_fails():
    """The reference in bfloat16 in the program's place fails the limits."""
    cell = _tiny("c3_octree_32k_fwdbwd", bounces=3)
    rows = harness.control_run(cell, [21, 22, 23], "cpu", report=open(os.devnull, "w"))
    for row in rows:
        assert judge.verdict(row["program"], cell.limits)
        assert not judge.verdict(row["control"], cell.limits)


def _broken_step(fault):
    real = program.System.step

    def step(self, rays):
        out = real(self, rays)
        n = out.hit.shape[1]
        if fault == "half":  # half the batch left out, the rest counted twice
            keep = torch.arange(n) < n // 2
            hit = out.hit & keep
            return out._replace(hit=hit, energy=out.energy * keep, hist=out.hist * 2,
                                grad=out.grad * 2)
        if fault == "energy":  # every 7th ray's energy altered where it is produced
            energy = out.energy.clone()
            energy[:, ::7] *= 0.999
            return out._replace(energy=energy)
        # an answer altered where it is produced: every 7th ray's bounce-1
        # polygon and arrival time
        poly, time_ = out.poly.clone(), out.time.clone()
        poly[0, ::7] = (poly[0, ::7] + 1) % self.absorption.shape[0]
        time_[0, ::7] *= 1.001
        return out._replace(poly=poly, time=time_)

    return step


@pytest.mark.parametrize("fault", ["half", "altered", "energy"])
def test_planted_faults_fail(monkeypatch, fault):
    monkeypatch.setattr(program.System, "step", _broken_step(fault))
    cell = _tiny("c3_octree_32k_fwdbwd", bounces=3)
    r = harness.run(cell, 2**31 + 5, 0.1, False, "cpu", time.time(), report=open(os.devnull, "w"))
    assert r["correct"] is False
    if fault == "energy":  # the sampled rays' own trace sees it too, not only their lanes
        assert r["checks"]["energy_gap"]["value"] > r["checks"]["energy_gap"]["limit"]


class _Event:
    def __init__(self, name, start, end, cuda=True):
        self._v = (name, start, end, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU


def test_step_device_ms_reads_the_devices_union_a_step():
    """The device's activity alone, read from a profile: overlapping kernels
    count once, copies count, host events and the harness's spans do not;
    per step of the window.  The cells that report it profile their
    untraced window; none reads it without a card."""
    from raybench import devtrace

    events = [_Event("k1", 1_000_000, 2_000_000), _Event("k2", 1_500_000, 3_000_000),
              _Event("Memset (Device)", 6_000_000, 6_500_000),
              _Event(devtrace.STEP, 0, 9_000_000), _Event("cudaLaunchKernel", 0, 9_000_000, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = devtrace.collect_device(prof, 2)
    assert [o.name for o in tr.kernels] == ["k1", "k2"] and len(tr.copies) == 1
    assert tr.window == (1_000_000, 6_500_000) and tr.steps == 2
    reader = cells._reader("step_device_ms", ROOT / "raybench")
    assert reader.read(SimpleNamespace(device=tr, devtrace=devtrace)) == pytest.approx(1.25)
    assert reader.read(SimpleNamespace(device=None, devtrace=devtrace)) is None
    for name in ("c3_octree_32k_fwdbwd", "c4_kd650k_vertices_fwdbwd"):
        cell = cells.resolve(name, ROOT)
        assert [m.name for m in cell.end_to_end if m.device_window] == ["step_device_ms"]
    cell = _tiny("c3_octree_32k_fwdbwd", bounces=2)
    r = harness.run(cell, 2**31 + 7, 0.1, False, "cpu", time.time(), report=open(os.devnull, "w"))
    assert r["correct"] is True and "step_device_ms" not in r["metrics"]
