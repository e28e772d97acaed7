"""K1's ray order on the CPU: the plain version of its key and its sort, the
key's bits in the kernels' source, the rule that decides when K1 orders a
shot, the cached scratch, and the wrapper's launch of the order (a stand-in
library records it; the kernels themselves run in
``tests/test_torch_cuda.py``)."""

import math
import re

import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel import common, voxel  # noqa: E402
from hare_tpu_torch.benchmarks import kernel_sweep  # noqa: E402
from hare_tpu_torch.kernels import build  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.utils import tracing  # noqa: E402

# An H100's K1 launch: 132 SMs x 8 blocks of 128 threads x 8 groups of 16
# lanes (hare_grid_shoot_capacity on the card: 8,448).
H100_RESIDENT_RAYS = 132 * 8 * 8


@pytest.fixture(scope="module")
def box_grid():
    """A 4 x 5 x 3 shoebox on a 4^3 grid, on the CPU."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    return th.SpatialPartition(top, accel="grid", domain=4, device="cpu").struct


def rays(o, d):
    return th.Ray.make(torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32))


def spread(v, axes, bits):
    """Bit k of v to bit k * axes: one axis of a Morton code of ``axes``."""
    return sum(((v >> k) & 1) << (k * axes) for k in range(bits))


@pytest.mark.parametrize("bits", [(4, 4), (3, 5), (0, 2), (2, 0)])
def test_order_keys_known_values(box_grid, bits):
    """Origins at the box's low and high corner and in its middle, and the
    six axis directions: the origin's cells (2^b an axis) as the high Morton
    bits, x highest; the octahedral map's cells (2^c an axis) as the low."""
    b, c = bits
    hp = box_grid.host_params
    lo, hi = hp[0:3], hp[3:6]
    mid = [(x + y) / 2 for x, y in zip(lo, hi)]
    top, half = (1 << c) - 1, 1 << c >> 1
    # direction -> its octahedral cells (u, v): +z maps to the centre, -z
    # folds to the corner (1, 1), +x to (1, 0), -y to (0, -1).
    dirs = {(0, 0, 1): (half, half), (0, 0, -1): (top, top), (1, 0, 0): (top, half),
            (-1, 0, 0): (0, half), (0, 1, 0): (half, top), (0, -1, 0): (half, 0)}
    for o, cell in ((lo, 0), (hi, (1 << b) - 1), (mid, 1 << b >> 1)):
        for d, (u, v) in dirs.items():
            key = int(voxel.grid_order_keys_plain(rays([o], [d]), box_grid, bits)[0])
            origin = sum(spread(cell, 3, b) << s for s in (2, 1, 0))
            assert key == (origin << 2 * c) | (spread(u, 2, c) << 1) | spread(v, 2, c), (o, d)


def test_order_keys_of_odd_rays(box_grid):
    """A NaN or far-off origin coordinate takes cell 0 or the last; a zero
    direction maps to the centre; every key fits its 3b + 2c bits."""
    b, c = voxel.ORDER_BITS
    nan, inf = math.nan, math.inf
    o = [[nan, 1.0, 1.0], [-1e30, 1e30, inf], [2.0, 2.0, 1.0], [2.0, 2.0, 1.0]]
    d = [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [nan, 0.0, 1.0]]
    keys = voxel.grid_order_keys_plain(rays(o, d), box_grid)
    assert keys.dtype == torch.int32 and bool(((keys >= 0) & (keys < 1 << (3 * b + 2 * c))).all())
    hi = (1 << b) - 1
    assert int(keys[1]) >> 2 * c == (spread(0, 3, b) << 2) | (spread(hi, 3, b) << 1) | spread(hi, 3, b)
    centre = 1 << c >> 1
    assert int(keys[2]) & ((1 << 2 * c) - 1) == (spread(centre, 2, c) << 1) | spread(centre, 2, c)
    assert int(keys[0]) >> 2 * c == int(voxel.grid_order_keys_plain(
        rays([[0.0, 1.0, 1.0]], [[0.0, 0.0, 1.0]]), box_grid)[0]) >> 2 * c


def test_order_plain_is_a_stable_sort(box_grid):
    """The plain order is a permutation whose keys do not decrease, rays of
    one key in index order; one origin leaves only the direction's bits."""
    g = torch.Generator().manual_seed(3)
    d = th.uniform_sphere(4096, g, device="cpu")
    o = torch.rand(4096, 3, generator=g) * torch.tensor([4.0, 5.0, 3.0])
    for r in (th.Ray.make(o, d), th.Ray.make(torch.full_like(d, 2.0), d)):
        keys, order = voxel.grid_order_plain(r, box_grid)
        assert order.dtype == torch.int32
        assert torch.equal(torch.sort(order.long()).values, torch.arange(4096))
        along = keys[order.long()]
        assert bool((along[1:] >= along[:-1]).all())
        tie = along[1:] == along[:-1]
        assert bool((order[1:][tie] > order[:-1][tie]).all())
    b, c = voxel.ORDER_BITS
    assert torch.unique(keys >> 2 * c).numel() == 1
    assert torch.unique(keys).numel() > 4096 // 2


def test_order_bits_are_the_kernels():
    """ORDER_BITS, the plain version's default, are the kernels' own
    kOriginBits and kDirBits."""
    src = (build.CSRC / "grid_shoot.cu").read_text()
    got = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                for k in ("kOriginBits", "kDirBits"))
    assert got == voxel.ORDER_BITS


@pytest.mark.parametrize("bits", [voxel.ORDER_BITS, (4, 4), (1, 8), (0, 10)])
def test_order_variant_sets_the_bits(bits):
    """The sweep's variant of K1 for other (b, c) is the built source with
    only the two constants changed; the built bits give the built source."""
    v = kernel_sweep.order_variant(bits)
    built = (build.CSRC / "grid_shoot.cu").read_text()
    assert f"constexpr int kOriginBits = {bits[0]};" in v.text
    assert f"constexpr int kDirBits = {bits[1]};" in v.text
    changed = [(x, y) for x, y in zip(built.splitlines(), v.text.splitlines()) if x != y]
    assert len(changed) == 2 * (bits[0] != voxel.ORDER_BITS[0] or bits[1] != voxel.ORDER_BITS[1])
    assert len(changed) in (0, 2) and v.label.startswith(f"{bits[0]}:{bits[1]}")
    assert v.label.endswith("(built)") == (tuple(bits) == voxel.ORDER_BITS)


# (shot, rays, whether K1 orders it) on an H100.  The bench scene's and
# the hall's grids take the same rule as config 5's 256^3 grid.
SHAPES = [
    ("config 5", 1 << 20, True),
    ("bench", 32_768, False),
    ("bench at 2^20 rays", 1 << 20, True),
    ("deep", 16_384, False),
    ("entry workload", 1_024, False),
    ("config 5 grid, a bench-sized shot", 32_768, False),
]


@pytest.mark.parametrize("name, n, engaged", SHAPES, ids=[s[0] for s in SHAPES])
def test_order_engages_by_shape(name, n, engaged):
    """The order engages only where the shot is many waves of the rays the
    card runs at once."""
    assert voxel.order_engages(n, H100_RESIDENT_RAYS) == engaged


@pytest.mark.parametrize("resident", [1, 100, H100_RESIDENT_RAYS])
def test_order_engages_at_the_edge(resident):
    """The edge lies at ORDER_MIN_WAVES waves of resident rays."""
    edge = voxel.ORDER_MIN_WAVES * resident
    assert voxel.order_engages(edge, resident) and not voxel.order_engages(edge - 1, resident)


@pytest.mark.parametrize("fill, dtype", [(None, torch.int32), (0, torch.int32),
                                         (common.NO_HIT_KEY, torch.int64)])
def test_stream_buffer_cached_by_name_and_stream(monkeypatch, fill, dtype):
    """One buffer per (name, device, stream), filled when made, kept while
    it is large enough and made anew, filled again, when it is not."""
    stream = {"now": 1}
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: stream["now"],
                        raising=False)
    monkeypatch.setattr(common, "_STREAM_BUFFERS", {})
    cpu = torch.device("cpu")
    a = common.stream_buffer("a", cpu, 8, dtype, fill)
    assert a.dtype == dtype and a.numel() == 8
    if fill is not None:
        assert bool((a == fill).all())
    assert common.stream_buffer("a", cpu, 5, dtype, fill) is a
    assert common.stream_buffer("b", cpu, 5, dtype, fill) is not a
    stream["now"] = 2
    assert common.stream_buffer("a", cpu, 5, dtype, fill) is not a
    stream["now"] = 1
    a.fill_(7)
    grown = common.stream_buffer("a", cpu, 9, dtype, fill)
    assert grown is not a and grown.numel() == 9
    assert common.stream_buffer("a", cpu, 9, dtype, fill) is grown
    if fill is not None:
        assert bool((grown == fill).all())


class _Recorder:
    """Stands in for the kernel library, recording each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


WAVES = voxel.ORDER_MIN_WAVES * 100  # rays at the rule's edge, 100 resident


@pytest.mark.parametrize("n, ordered, engaged", [(WAVES, None, True), (WAVES - 1, None, False),
                                                 (WAVES, False, False), (8, True, True)])
def test_wrapper_launches_the_order(monkeypatch, box_grid, n, ordered, engaged):
    """The wrapper asks the rule (here: 100 rays resident, 64 fixed scratch
    words), and where it engages passes one launch of hare_grid_shoot the
    order's zeroed scratch and counts the shot under rays.ordered;
    otherwise a null order."""
    rec = _Recorder()
    monkeypatch.setattr(build, "library", lambda: rec)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(voxel, "card_capacity", lambda dev, kernel="watertight": (100, 64))
    monkeypatch.setattr(common, "_STREAM_BUFFERS", {})
    d = th.uniform_sphere(n, torch.Generator().manual_seed(0), device="cpu")
    r = th.Ray.make(torch.full_like(d, 2.0), d)
    tracing.reset()
    t, tri, got = voxel._grid_shoot_card(r, box_grid, ordered=ordered)
    assert t.shape == tri.shape == (n,)
    (name, args), = rec.calls
    assert name == "hare_grid_shoot" and len(args) == len(build._SIGNATURES[name])
    fparams, iparams, order = args[7], args[8], args[11]
    assert len(fparams) == 14 and len(iparams) == 6
    counted = tracing.snapshot().counters.get("rays.ordered", 0)
    if engaged:
        ((name, _, _), buf), = (
            (k, v) for k, v in common._STREAM_BUFFERS.items() if k[0] != "ray_counter")
        assert name == "grid_order"
        assert order == buf.data_ptr() and buf.numel() >= 64 + 3 * n
        assert bool((buf == 0).all()) and counted == n
        assert got.keys.numel() == got.order.numel() == n
    else:
        assert order is None and got is None and counted == 0
    tracing.reset()
