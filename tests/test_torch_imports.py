"""Guards of the PyTorch port: no JAX, no silent fallbacks, no dropped knobs."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.common import finalize_hits, finalize_hits_bwd  # noqa: E402
from hare_tpu_torch.accel.scatter import scatter_add_ordered  # noqa: E402
from hare_tpu_torch.accel.voxel import grid_shoot  # noqa: E402
from hare_tpu_torch.benchmarks import pallas_probe  # noqa: E402
from hare_tpu_torch.kernels import build  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace.bounce import (  # noqa: E402
    hard_histogram_bwd,
    histogram_kernel,
    soft_histogram_bwd,
)

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "hare_tpu", "optax", "orbax")  # compared as whole first components


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


def test_utils_and_examples_load_no_jax():
    """The utilities, both programs and the flagship workload
    (``hare_tpu_torch.entry``) import neither JAX nor the JAX package, optax
    or orbax."""
    code = (
        "import sys, hare_tpu_torch.utils\n"
        "import hare_tpu_torch.examples.fit_absorption, hare_tpu_torch.examples.fit_vertices\n"
        "from hare_tpu_torch.entry import dryrun_multichip, entry\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'hare_tpu', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_no_jax_or_hare_tpu_imports_in_source():
    files = sorted((ROOT / "hare_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {"fit_absorption.py", "fit_vertices.py", "checkpoint.py", "closest.py",
            "entry.py"} <= {f.name for f in files}
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
    """Scattering and remat are ported: scattering without its generator
    raises, as the JAX package raises without a key; remat runs.  An
    unknown triangle kernel raises."""
    sp = th.SpatialPartition(room, domain=4, device=CPU)
    rays = th.Ray.make(torch.full((4, 3), 1.0), torch.tensor([[1.0, 0.0, 0.0]] * 4))
    a = torch.zeros(room.n_polys)
    with pytest.raises(ValueError, match="Generator"):
        th.trace_rays(sp.scene, rays, a, 2, sp.shoot_fn, aux=sp.aux,
                      scattering=torch.zeros(room.n_polys))
    res = th.trace_rays(sp.scene, rays, a, 2, sp.shoot_fn, aux=sp.aux, remat=True,
                        scattering=torch.zeros(room.n_polys),
                        generator=torch.Generator().manual_seed(0))
    assert bool(res.hit.all())
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
        hard_histogram_bwd(e, res.hit, torch.ones(8, device=meta), 8, 1e-3)
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


# What the JAX package has and the port has not, each with its reason.
UNPORTED = {
    "make_ray_mesh": "a torch.distributed process group takes the device mesh's place",
    "straggler_tiers": "TPU workaround: resume rounds for rays a round leaves unfinished",
    "collect": "TPU workaround: candidate buffers filled before the triangle test",
    "run_round": "TPU workaround: bounded traversal rounds",
    "quant": "TPU workaround: 8-bit quantised packed stacks",
}
# The classes whose public methods and fields the port keeps.
CLASSES = {"Scene": "mesh/scene.py", "Topology": "mesh/topology.py",
           "SpatialPartition": "accel/partition.py", "TraceResult": "trace/bounce.py"}


def _all_names(path):
    """A module's ``__all__`` literal, read from its source."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    return []


def _defs(path, nested=False):
    """Public function and class names defined in a module's source: at
    its top level, or (``nested``) anywhere."""
    body = ast.walk(ast.parse(path.read_text())) if nested else ast.parse(path.read_text()).body
    return {n.name for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _members(path, cls):
    """Public methods, properties and fields of class ``cls`` in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {getattr(b, "name", None) or b.target.id for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AnnAssign))
                    and not (getattr(b, "name", None) or b.target.id).startswith("_")}
    raise AssertionError(f"no class {cls} in {path}")


def test_api_parity():
    """The port does everything the JAX package does: every name in each
    ``hare_tpu`` package's ``__all__``, every public function and class of
    each of its modules (read from the source, so no JAX is imported), and
    every public method and field of Scene, Topology, SpatialPartition and
    TraceResult has a counterpart in ``hare_tpu_torch``, but the UNPORTED
    names, each with its reason, which the JAX package has and the port
    has not."""
    import importlib

    jax_root, port_root = ROOT / "hare_tpu", ROOT / "hare_tpu_torch"
    missing, jax_defs, port_defs = [], set(), set()
    for init in sorted(jax_root.rglob("__init__.py")):
        sub = init.parent.relative_to(jax_root).parts
        port = importlib.import_module(".".join(("hare_tpu_torch",) + sub))
        missing += [f"{port.__name__}.{n}" for n in _all_names(init)
                    if n not in UNPORTED and not hasattr(port, n)]
    for src in sorted(jax_root.rglob("*.py")):
        twin = port_root / src.relative_to(jax_root)
        jax_defs |= _defs(src, nested=True)
        if not twin.exists():
            missing.append(f"{twin.relative_to(ROOT)}")
            continue
        missing += [f"{twin.relative_to(ROOT)}: {n}" for n in _defs(src) - _defs(twin)
                    if n not in UNPORTED]
    for cls, rel in CLASSES.items():
        missing += [f"{cls}.{n}" for n in _members(jax_root / rel, cls)
                    - _members(port_root / rel, cls)]
    assert not missing, missing
    for src in port_root.rglob("*.py"):
        port_defs |= _defs(src, nested=True)
    assert set(UNPORTED) <= jax_defs and not set(UNPORTED) & port_defs


_TPU_KNOB = ("a TPU traversal knob (candidate buffers, rounds, straggler tiers, push order); "
             "the port's kernels, one thread or lane group a ray, have none, and "
             "SpatialPartition raises on it (test_tpu_knobs_raise)")
_TPU_TABLE = ("a TPU table field: the port keeps the same tables repacked for one thread a "
              "candidate (win_geom and win_ids, typed node tensors), built from these fields "
              "by from_numpy")
# Parameters of the JAX package's public functions and methods, and fields of
# its classes, that the port's counterpart lacks: ``function.parameter``,
# ``Class.method.parameter`` or ``Class.field``, each under its reason.
PARAMS_UNPORTED = {
    "an explicit torch.Generator (``generator``) takes the place of a jax.random key": {
        "cosine_lobe.key", "trace_rays.key", "uniform_sphere.key", "triangle_points.key",
        "polygon_points.key", "scene_surface_points.key"},
    "a torch.distributed process group (``group``) takes the place of the device mesh "
    "and its axis": {
        "sharded_histogram.mesh", "sharded_histogram.axis", "make_train_step.mesh",
        "make_train_step.axis"},
    _TPU_KNOB: {
        "shoot_grid.cap", "shoot_grid.soft", "shoot_grid.tier", "shoot_grid.cap_s",
        "shoot_tree.cap", "shoot_tree.march", "shoot_tree.ordered",
        "shoot_kdtree_ropes.cap", "shoot_kdtree_ropes.march",
        "HareConfig.cap", "HareConfig.march", "HareConfig.soft", "HareConfig.tier",
        "HareConfig.cap_s"},
    "passes the TPU knobs on to shoot_tree": {"shoot_octree.**kw", "shoot_kdtree.**kw"},
    "counts the TPU walk's collect-then-test rounds and candidate rows, which K1 does not "
    "have; voxel.grid_work counts K1's cells and triangle slots": {"shoot_grid.with_stats"},
    _TPU_TABLE: {
        "VoxelGrid.win_data", "TreeTables.win_data", "TreeTables.node_rows",
        "KDRopes.win_data", "KDRopes.node_rows"},
    "sizes a TPU candidate buffer, which the port's walks do not have": {
        "TreeTables.row_width", "TreeTables.max_node_need", "KDRopes.max_leaf_wins"},
    "the TPU test phase's candidate buffer and carried state; the port's test_windows "
    "takes the window rows to test and returns the nearest hit": {
        "test_windows.win_data", "test_windows.buf", "test_windows.active",
        "test_windows.best_t", "test_windows.best_tri"},
}
# Parameters the port has with fewer values than the JAX package.
VALUES_UNPORTED = {
    "``dtype`` is float32 only and any other raises ValueError: every kernel reads f32 "
    "scenes, and the JAX package, which never enables x64, makes f32 arrays for "
    "``np.float64`` too": {"build_scene.dtype", "Topology.scene.dtype"},
}


def _signatures(path):
    """``{name: FunctionDef}`` of a module's public functions (``fn``), its
    classes' public methods (``Class.fn``) and its classes (``Class``)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out[node.name] = node
            out.update({f"{node.name}.{b.name}": b for b in node.body
                        if isinstance(b, ast.FunctionDef) and not b.name.startswith("_")})
    return out


def _params(node):
    """(parameter names in order, ``{name: default source}``) of a function,
    or of a class: its annotated fields, its constructor's parameters.  A
    default names its dtype without the module (``jnp.float32`` and
    ``torch.float32`` are one default)."""
    if isinstance(node, ast.ClassDef):
        return [b.target.id for b in node.body if isinstance(b, ast.AnnAssign)], {}
    a = node.args
    pos = a.posonlyargs + a.args
    names = [x.arg for x in pos + a.kwonlyargs]
    names += [f"*{x.arg}" for x in (a.vararg,) if x] + [f"**{x.arg}" for x in (a.kwarg,) if x]
    given = list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) + [
        (x, d) for x, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
    return names, {x.arg: d.attr if isinstance(d, ast.Attribute) else ast.unparse(d)
                   for x, d in given}


def test_parameter_parity():
    """The port does what the JAX package does parameter by parameter: every
    parameter of every public JAX function and method, and every field of
    every JAX class, exists in the port's counterpart (read from the
    sources, so no JAX is imported), with JAX's default and in JAX's order,
    but the PARAMS_UNPORTED entries, each under its reason; the allow-list
    holds nothing the port has.  VALUES_UNPORTED's ``dtype`` raises beyond
    float32."""
    jax_root, port_root = ROOT / "hare_tpu", ROOT / "hare_tpu_torch"
    allowed = {name: why for why, names in PARAMS_UNPORTED.items() for name in names}
    assert all(len(why) > 20 for why in list(PARAMS_UNPORTED) + list(VALUES_UNPORTED))
    missing, wrong = set(), []
    for src in sorted(jax_root.rglob("*.py")):
        twin = port_root / src.relative_to(jax_root)
        if not twin.exists():
            continue  # test_api_parity's
        jdefs, pdefs = _signatures(src), _signatures(twin)
        for name, node in jdefs.items():
            if name not in pdefs:
                continue  # test_api_parity's
            (jn, jd), (pn, pd) = _params(node), _params(pdefs[name])
            missing |= {f"{name}.{p}" for p in jn if p not in pn}
            shared = [p for p in jn if p in pn]
            if shared != [p for p in pn if p in jn]:
                wrong.append(f"{name}: order {shared} against {pn}")
            wrong += [f"{name}.{p}: default {pd.get(p)} against JAX's {jd[p]}"
                      for p in shared if p in jd and pd.get(p) != jd[p]]
    assert not wrong, wrong
    assert missing == set(allowed), (sorted(missing - set(allowed)),
                                     sorted(set(allowed) - missing))

    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    for call in (lambda dtype: th.build_scene([top], dtype=dtype, device=CPU),
                 lambda dtype: top.scene(dtype=dtype, device=CPU)):
        assert call(np.float32).vertices.dtype == torch.float32
        with pytest.raises(ValueError, match="float32"):
            call(np.float64)
