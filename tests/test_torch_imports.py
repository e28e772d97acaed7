"""Guards of the PyTorch port: no JAX, no silent fallbacks, no dropped knobs."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.common import finalize_hits, finalize_hits_bwd  # noqa: E402
from hare_tpu_torch.accel.scatter import scatter_add_ordered  # noqa: E402
from hare_tpu_torch.accel.voxel import grid_shoot  # noqa: E402
from hare_tpu_torch.benchmarks import pallas_probe  # noqa: E402
from hare_tpu_torch.kernels import build  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace.bounce import histogram_kernel, soft_histogram_bwd  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "hare_tpu")  # compared as whole first components


def test_import_loads_no_jax():
    code = (
        "import sys, hare_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hare_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_benchmarks_load_no_jax():
    code = (
        "import sys, hare_tpu_torch\n"
        "assert 'hare_tpu_torch.benchmarks' not in sys.modules\n"
        "import hare_tpu_torch.benchmarks.pallas_probe, hare_tpu_torch.benchmarks.r4_dyngather_probe\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hare_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_no_jax_or_hare_tpu_imports_in_source():
    files = sorted((ROOT / "hare_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{f}: imports {name}"


@pytest.fixture(scope="module")
def room():
    return th.Topology.build(shapes.shoebox(4, 5, 3))


@pytest.mark.parametrize("accel, exc", [
    ("octree", None), ("brute", None), ("kdtree", None), ("kdtree_ropes", None),
    ("bvh", ValueError),
])
def test_unported_accel_raises(room, accel, exc):
    """Every backend of the JAX package is ported: each builds on the room
    and shoots one ray straight up to the ceiling; an unknown name raises."""
    if exc is not None:
        with pytest.raises(exc, match=accel):
            th.SpatialPartition(room, accel=accel, device=CPU)
        return
    sp = th.SpatialPartition(room, accel=accel, device=CPU)
    hr = sp.shoot(th.Ray.make(torch.tensor([[2.0, 2.5, 1.0]]), torch.tensor([[0.0, 0.0, 1.0]])))
    assert bool(hr.hit[0]) and abs(float(hr.t[0]) - 2.0) < 1e-5


KNOBS = ["cap", "soft", "tier", "cap_s", "march"]


@pytest.mark.parametrize("knob, accel", [pytest.param(k, "grid", id=k) for k in KNOBS] + [
    pytest.param(k, a, id=f"{a}-{k}")
    for a in ("brute", "octree", "kdtree", "kdtree_ropes") for k in KNOBS
])
def test_tpu_knobs_raise(room, knob, accel):
    with pytest.raises(ValueError, match=knob):
        th.SpatialPartition(room, accel=accel, device=CPU, **{knob: 8})


def test_unported_trace_features_raise(room):
    sp = th.SpatialPartition(room, domain=4, device=CPU)
    rays = th.Ray.make(torch.full((4, 3), 1.0), torch.tensor([[1.0, 0.0, 0.0]] * 4))
    a = torch.zeros(room.n_polys)
    with pytest.raises(NotImplementedError, match="scattering"):
        th.trace_rays(sp.scene, rays, a, 2, sp.shoot_fn, aux=sp.aux,
                      scattering=torch.zeros(room.n_polys))
    with pytest.raises(NotImplementedError, match="remat"):
        th.trace_rays(sp.scene, rays, a, 2, sp.shoot_fn, aux=sp.aux, remat=True)
    with pytest.raises(ValueError, match="kernel"):
        th.SpatialPartition(room, domain=4, kernel="fast", device=CPU)


def test_wrappers_never_fall_back(room):
    """A tensor on a device with neither a kernel nor a plain version raises;
    on a host without CUDA the kernel launchers raise instead of running the
    plain version."""
    grid = th.accel.build_voxel_grid(room, domain=4, device=CPU)
    meta = torch.device("meta")
    rays = th.Ray.make(torch.zeros(4, 3, device=meta), torch.ones(4, 3, device=meta))
    meta_grid = grid._replace(cell_meta=grid.cell_meta.to(meta), win_geom=grid.win_geom.to(meta))
    with pytest.raises(ValueError, match="meta"):
        grid_shoot(rays, meta_grid)
    scene = th.build_scene([room], device=CPU)
    with pytest.raises(ValueError, match="meta"):
        finalize_hits(scene, rays, torch.zeros(4, device=meta),
                      torch.zeros(4, dtype=torch.int32, device=meta))
    e = torch.ones(2, 3, device=meta)
    res = th.TraceResult(torch.ones(2, 3, dtype=torch.bool, device=meta), e, e, None, None, None)
    with pytest.raises(ValueError, match="meta"):
        th.energy_histogram(res, 8)
    with pytest.raises(ValueError, match="meta"):
        th.energy_histogram(res, 8, soft=True)
    with pytest.raises(ValueError, match="meta"):
        soft_histogram_bwd(e, e, res.hit, torch.ones(8, device=meta), 8, 1e-3)
    with pytest.raises(ValueError, match="meta"):
        scatter_add_ordered(torch.zeros(4, dtype=torch.int32, device=meta),
                            torch.ones(4, device=meta), 2)
    ids = torch.zeros(4, dtype=torch.int32, device=meta)
    cts = (rays.origin[:, 0],) * 3 + (rays.origin,) * 2
    with pytest.raises(ValueError, match="meta"):
        finalize_hits_bwd(scene.vertices.to(meta), scene.tri_meta.to(meta), ids,
                          rays.origin[:, 0], ids.bool(), rays.origin, rays.direction, cts)
    if torch.cuda.is_available():
        return  # the rest is about hosts without a card
    with pytest.raises(RuntimeError, match="CUDA"):
        build.library()
    with pytest.raises(RuntimeError, match="CUDA"):
        histogram_kernel(torch.ones(8), torch.zeros(8), torch.ones(8, dtype=torch.bool), 4, 1e-3)


def test_probe_wrappers_never_fall_back():
    """The probe kernels' wrappers raise on a device with neither a kernel
    nor a plain version, and, without a card, on the way to the kernel."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="meta"):
        pallas_probe.column_sum(torch.ones(64, 192, device=meta))
    idx = torch.zeros(8, dtype=torch.int32, device=meta)
    for dtype in (torch.float32, torch.int32):
        with pytest.raises(ValueError, match="meta"):
            pallas_probe.gather_sum(torch.ones(16, 2, dtype=dtype, device=meta), idx, 3)
    with pytest.raises(ValueError, match="several devices"):
        pallas_probe.gather_sum(torch.ones(16, 2), idx, 3)
    if torch.cuda.is_available():
        return  # the rest is about hosts without a card
    with pytest.raises(RuntimeError, match="CUDA"):
        pallas_probe.probe_meta_gather(16, 8, 2, device="cpu")


def test_kernel_sources_present():
    """Every C entry point bound in build.py is defined in csrc/."""
    src = "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    for name in build._SIGNATURES:
        assert f'extern "C" int {name}(' in src, name
