"""Port parity: brute force (B1's plain version) and the f64 oracle.

Mirrors ``tests/test_brute.py`` on the port: the port's brute shoot against
the port's float64 oracle, which is itself held against ``hare_tpu.oracle``
on the same rays; and the port's brute shoot against the JAX ``shoot_brute``
on identical scene tables.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import shoot_brute as j_shoot_brute  # noqa: E402
from hare_tpu.geom import intersect as j_intersect  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402
from hare_tpu.oracle import oracle_shoot as j_oracle_shoot  # noqa: E402
from hare_tpu.oracle import oracle_trace as j_oracle_trace  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.brute import brute_shoot, shoot_brute  # noqa: E402
from hare_tpu_torch.convert import scene_from_numpy  # noqa: E402
from hare_tpu_torch.geom import intersect  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.oracle import oracle_shoot, oracle_trace  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# The oracle's tolerances (tests/test_brute.py:19-40): an f32 shoot against
# an f64 scan.
ORACLE_T_ATOL = ORACLE_POINT_ATOL = 1e-3
# Port against JAX on identical tables: the same f32 test, re-solved by two
# compilers — a few ulps (tests/test_torch_voxel.py).
RTOL = ATOL = 1e-5
# Rays whose tri_id differs while both t agree (an equal-t tie resolved on a
# last-ulp difference) may be at most this share.
MAX_TIE_SHARE = 1e-3


def random_rays(rng, n, lo=(0.5, 0.5, 0.5), hi=(3.5, 4.5, 2.5)):
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def t_rays(o, d, ex=None):
    return th.Ray.make(
        torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
        None if ex is None else torch.as_tensor(np.asarray(ex, np.int32)),
    )


def check_against_oracle(top, o, d, exclude=None, kernel="mt"):
    """tests/test_brute.py::check_against_oracle on the port."""
    hr = shoot_brute(top.scene(device=CPU), t_rays(o, d, exclude), kernel=kernel)
    hit = hr.hit.numpy()
    for i in range(len(o)):
        exc = (-1, -1) if exclude is None else tuple(exclude[i])
        ref = oracle_shoot(top, o[i], d[i], exc)
        if ref is None:
            assert not hit[i], f"ray {i}: port hit, oracle missed"
        else:
            assert hit[i], f"ray {i}: oracle hit poly {ref['poly_id']}, port missed"
            assert abs(float(hr.t[i]) - ref["t"]) < ORACLE_T_ATOL, i
            np.testing.assert_allclose(hr.point[i].numpy(), ref["point"], atol=ORACLE_POINT_ATOL)
            assert int(hr.poly_id[i]) == ref["poly_id"], i
    return hr


def test_shoebox_agreement(rng):
    o, d = random_rays(rng, 200)
    hr = check_against_oracle(th.Topology.build(shapes.shoebox()), o, d)
    assert hr.hit.all()  # closed room: every ray hits


def test_quads_agreement(rng):
    o, d = random_rays(rng, 100)
    check_against_oracle(th.Topology.build(shapes.shoebox_quads()), o, d)


@pytest.mark.parametrize("kernel, seed", [("mt", 3), ("watertight", 5)])
def test_soup_agreement(rng, kernel, seed):
    top = th.Topology.build(shapes.random_soup(150, seed=seed))
    o = rng.uniform(-2, 12, (150, 3))
    d = rng.normal(0, 1, (150, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hr = check_against_oracle(top, o, d, kernel=kernel)
    assert hr.hit.sum() > 10


def test_oracle_matches_jax_oracle(rng):
    """The port's oracle is a copy: the same hits, bit for bit, on the same
    rays, with and without exclusions, and the same bounce trace."""
    faces = shapes.random_soup(60, seed=9)
    tt, jt = th.Topology.build(faces), jh.Topology.build(jshapes.random_soup(60, seed=9))
    o = rng.uniform(-2, 12, (40, 3))
    d = rng.normal(0, 1, (40, 3))
    for i in range(len(o)):
        for exc in ((-1, -1), (int(tt.tri_poly[i % tt.n_tris]), -1)):
            a, b = oracle_shoot(tt, o[i], d[i], exc), j_oracle_shoot(jt, o[i], d[i], exc)
            assert (a is None) == (b is None), i
            if a is not None:
                for k in ("t", "u", "v", "poly_id", "tri_id"):
                    assert a[k] == b[k], (i, k)
                np.testing.assert_array_equal(a["point"], b["point"])
    room_t, room_j = th.Topology.build(shapes.shoebox()), jh.Topology.build(jshapes.shoebox())
    absorption = np.linspace(0.1, 0.6, room_t.n_polys)
    for i in range(5):
        a = oracle_trace(room_t, (2.0, 2.5, 1.5), d[i], absorption, 4)
        b = j_oracle_trace(room_j, (2.0, 2.5, 1.5), d[i], absorption, 4)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x["t"] == y["t"] and x["energy"] == y["energy"] and x["time"] == y["time"]


@pytest.mark.parametrize("which", ["mt", "watertight"])
def test_vector_wrappers_match_jax(rng, which):
    """ray_triangle_mt / ray_triangle_watertight on (..., 3) vectors."""
    n = 500
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    v0, v1, v2 = (rng.uniform(-2, 2, (n, 3)).astype(np.float32) for _ in range(3))
    ours = getattr(intersect, f"ray_triangle_{which}")(*map(torch.from_numpy, (o, d, v0, v1, v2)))
    ref = getattr(j_intersect, f"ray_triangle_{which}")(o, d, v0, v1, v2)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    ok = np.asarray(ref[0])
    assert ok.sum() > 20
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=RTOL, atol=ATOL)


def _jax_and_port_scene(faces_fn):
    jsc = jh.Topology.build(faces_fn(jshapes)).scene()
    return jsc, scene_from_numpy({k: np.asarray(v) for k, v in jsc._asdict().items()}, device=CPU)


@pytest.mark.parametrize("name", ["shoebox", "soup", "hall"])
def test_brute_parity_with_jax(rng, name):
    """The port's brute shoot against JAX shoot_brute on identical tables."""
    faces_fn, box = {
        "shoebox": (lambda s: s.shoebox(4, 5, 3), ((0.2,) * 3, (3.8, 4.8, 2.8))),
        "soup": (lambda s: s.random_soup(300, seed=11), ((-1,) * 3, (11,) * 3)),
        "hall": (lambda s: s.concert_hall(), ((2, 2, 1), (28, 48, 16))),
    }[name]
    jsc, tsc = _jax_and_port_scene(faces_fn)
    o, d = random_rays(rng, 256, *box)
    o, d = o.astype(np.float32), d.astype(np.float32)
    hj = jax.tree.map(np.asarray, j_shoot_brute(jsc, jh.Ray.make(o, d)))
    ht = shoot_brute(tsc, t_rays(o, d))
    h = hj.hit
    np.testing.assert_array_equal(ht.hit.numpy(), h)
    np.testing.assert_allclose(ht.t.numpy()[h], hj.t[h], rtol=RTOL, atol=ATOL)
    same = (ht.tri_id.numpy() == hj.tri_id) & h
    flips = h & ~same
    # The concert hall has coincident overlapping polygons (stage and floor):
    # equal-t ties there are common, and XLA's fused batched test rounds them
    # one ulp apart.  Elsewhere ties are measure-zero.
    assert flips.sum() <= (0.02 if name == "hall" else MAX_TIE_SHARE) * len(h), flips.sum()
    for f in ("u", "v", "point", "normal"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[same], getattr(hj, f)[same],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(ht.poly_id.numpy()[same], hj.poly_id[same])


def test_exclusion():
    """poly_origin exclusion skips the origin polygon (Spatial_Partition.cs:33)."""
    top = th.Topology.build(shapes.shoebox())
    o = np.array([[2.0, 2.5, 0.0]] * 2)
    d = np.array([[0, 0, 1.0]] * 2)
    ceil = [p for p in range(12) if np.allclose(top.poly_normal[p], [0, 0, -1])]
    ex = [[-1, -1], [ceil[0], ceil[1]]]
    hr = shoot_brute(top.scene(device=CPU), t_rays(o, d, ex))
    assert bool(hr.hit[0]) and int(hr.poly_id[0]) in ceil
    assert not bool(hr.hit[1])


def test_tiling_invariance(rng):
    """The plain version's answer does not depend on its triangle tile."""
    sc = th.Topology.build(shapes.random_soup(200, seed=7)).scene(device=CPU)
    o = rng.uniform(0, 10, (64, 3))
    d = rng.normal(0, 1, (64, 3))
    rays = t_rays(o, d / np.linalg.norm(d, axis=1, keepdims=True))
    (ta, ia), (tb, ib) = brute_shoot(sc, rays, tri_tile=64), brute_shoot(sc, rays, tri_tile=4096)
    assert torch.equal(ia, ib) and torch.equal(ta, tb)
    assert torch.isfinite(ta).sum() > 10


def floor_tris(n):
    """An n x n floor of unit squares at z = 0, two triangles each."""
    out = []
    for i in range(n):
        for j in range(n):
            q = np.array([[i, j, 0], [i + 1, j, 0], [i + 1, j + 1, 0], [i, j + 1, 0]], float)
            out += [q[[0, 1, 2]], q[[2, 3, 0]]]
    return out


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_tiling_keys_with_straddling_ties(rng, kernel):
    """B1's slabs merge each ray's hit keys with a min, so the answer must
    not depend on how the triangles are cut: the plain version gives the
    same (t, tri) bits with tiles of 1, 7 and all triangles, where every ray
    ends on an exact tie between twins in two topologies (the second in
    reverse order), in different tiles; the lower id wins."""
    floor = floor_tris(3)
    tops = [th.Topology.build(floor), th.Topology.build(floor[::-1])]
    sc = th.build_scene(tops, device=CPU)
    n_first = tops[0].n_tris
    o = np.stack([rng.uniform(0.5, 2.5, 512), rng.uniform(0.5, 2.5, 512),
                  rng.uniform(0.5, 2.0, 512)], 1)
    d = np.stack([rng.normal(0, 0.05, 512), rng.normal(0, 0.05, 512), -np.ones(512)], 1)
    rays = t_rays(o, d / np.linalg.norm(d, axis=1, keepdims=True))
    outs = [brute_shoot(sc, rays, kernel, tri_tile=tile) for tile in (1, 7, sc.tri_geom.shape[0])]
    t, tri = outs[0]
    assert bool(torch.isfinite(t).all()) and bool((tri < n_first).all())
    for t_k, tri_k in outs[1:]:
        assert torch.equal(t_k.view(torch.int32), t.view(torch.int32)) and torch.equal(tri_k, tri)
    # Every ray's twin, with the winner's polygon excluded, lies at the same t.
    poly = sc.tri_poly[tri.long()]
    ex = torch.stack([poly, torch.full_like(poly, -1)], 1).int()
    t2, tri2 = brute_shoot(sc, rays._replace(exclude_poly=ex), kernel, tri_tile=7)
    assert torch.equal(t2, t) and bool((tri2 >= n_first).all())


def test_hit_invariants(rng):
    """Hit point on the triangle's plane, t = |x - o|, u, v barycentric."""
    top = th.Topology.build(shapes.shoebox())
    o, d = random_rays(rng, 300)
    hr = shoot_brute(top.scene(device=CPU), t_rays(o, d))
    hit = hr.hit.numpy()
    assert hit.all()
    pt, t = hr.point.numpy()[hit], hr.t.numpy()[hit]
    u, v, tri = hr.u.numpy()[hit], hr.v.numpy()[hit], hr.tri_id.numpy()[hit]
    assert (u >= -1e-5).all() and (v >= -1e-5).all() and (u + v <= 1 + 1e-5).all()
    np.testing.assert_allclose(t, np.linalg.norm(pt - o[hit], axis=1), atol=1e-4)
    n = top.poly_normal[top.tri_poly[tri]]
    p0 = top.vertices[top.tri_v[tri][:, 0]]
    assert np.abs(np.einsum("ij,ij->i", pt - p0, n)).max() < 1e-3


def test_multi_topology_top_index(rng):
    """top_index restricts the query to one topology (Spatial_Partition.cs:32)."""
    t1 = th.Topology.build(shapes.shoebox())
    t2 = th.Topology.build(shapes.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5)))
    sc = th.build_scene([t1, t2], device=CPU)
    d = rng.normal(0, 1, (8, 3))
    rays = t_rays(np.tile([[2.0, 2.5, 1.5]], (8, 1)), d / np.linalg.norm(d, axis=1, keepdims=True))
    all_hit, only_room = shoot_brute(sc, rays), shoot_brute(sc, rays, top_index=0)
    assert all_hit.hit.all() and only_room.hit.all()
    assert (all_hit.t <= only_room.t + 1e-6).all()
    assert set(sc.tri_top[only_room.tri_id.long()].tolist()) == {0}
    assert set(sc.tri_top[all_hit.tri_id.long()].tolist()) == {1}
