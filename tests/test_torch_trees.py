"""Port parity: octree, KD-tree and KD-rope builders and their walks (B2, B3).

Mirrors ``tests/test_trees.py`` on the port.  Every table a copied builder
makes is bit-equal to the JAX builder's, and the repacked layouts hold the
same boxes, ids and window rows.  The plain walks agree with the JAX brute
shoot on identical scene tables (the JAX tree shoots themselves are held
against through the facade, ``tests/test_torch_partition.py``).
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import build_kdtree as j_build_kdtree  # noqa: E402
from hare_tpu.accel import build_octree as j_build_octree  # noqa: E402
from hare_tpu.accel import shoot_brute as j_shoot_brute  # noqa: E402
from hare_tpu.accel.ropes import build_kdtree_ropes as j_build_ropes  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel import kdtree, octree, ropes, tree  # noqa: E402
from hare_tpu_torch.accel.brute import shoot_brute  # noqa: E402
from hare_tpu_torch.convert import ropes_from_numpy, scene_from_numpy, tree_from_numpy  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# Port against JAX brute: the same f32 test, re-solved by two compilers.
RTOL, ATOL = 1e-5, 1e-6
# Rays whose tri_id differs while both t agree may be at most this share,
# except on the concert hall, whose coincident overlapping polygons (stage
# and floor) make equal-t ties common: there 2 %.
MAX_TIE_SHARE, HALL_TIE_SHARE = 1e-3, 0.02

SCENES = {
    "room": (lambda s: s.shoebox(4, 5, 3), ((0.2, 0.2, 0.2), (3.8, 4.8, 2.8))),
    "soup": (lambda s: s.random_soup(300, seed=17), ((-1,) * 3, (11,) * 3)),
    "hall": (lambda s: s.concert_hall(), ((2, 2, 1), (28, 48, 16))),
}
# (JAX builder, port table builder, build keywords)
BUILDS = {
    "octree": (j_build_octree, octree.build_octree_tables, {}),
    "kdtree_sah": (j_build_kdtree, kdtree.build_kdtree_tables, {}),
    "kdtree_median": (j_build_kdtree, kdtree.build_kdtree_tables, dict(split="median")),
    "kdtree_levels3": (j_build_kdtree, kdtree.build_kdtree_tables, dict(levels=3)),
    "ropes": (j_build_ropes, ropes.build_kdtree_ropes_tables, {}),
    "ropes_median": (j_build_ropes, ropes.build_kdtree_ropes_tables, dict(split="median")),
}


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def t_rays(o, d, ex=None):
    return th.Ray.make(
        torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
        None if ex is None else torch.as_tensor(np.asarray(ex, np.int32)),
    )


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX topology, port topology, JAX scene, port scene from it)."""
    out = {}
    for name, (faces, _) in SCENES.items():
        jt, tt = jh.Topology.build(faces(jshapes)), th.Topology.build(faces(shapes))
        jsc = jt.scene()
        out[name] = (jt, tt, jsc, scene_from_numpy({k: np.asarray(v) for k, v in jsc._asdict().items()}, device=CPU))
    return out


@pytest.mark.parametrize("kind", sorted(BUILDS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tables_bit_equal(scenes, scene, kind):
    """The copied builders make the JAX tables bit for bit, and the repack
    keeps every box, id and window row."""
    jt, tt, _, _ = scenes[scene]
    j_build, t_build, kw = BUILDS[kind]
    jtab, tab = j_build(jt, **kw), t_build(tt, **kw)
    for f in ("node_rows", "win_data", "root_min", "root_max"):
        np.testing.assert_array_equal(tab[f], np.asarray(getattr(jtab, f)), err_msg=f)
    statics = ("max_depth", "char_step", "max_leaf_wins", "n_tris") if kind.startswith("ropes") \
        else ("branch", "max_depth", "row_width", "max_node_need")
    for f in statics:
        assert tab[f] == getattr(jtab, f), f

    rows = tab["node_rows"]
    irows = rows.view(np.int32)
    if kind.startswith("ropes"):
        st = ropes.KDRopes.from_numpy(**tab, device=CPU)
        np.testing.assert_array_equal(st.node[:, 0].numpy(), irows[:, 0] >> 1)
        np.testing.assert_array_equal(st.node[:, 1].numpy(), irows[:, 0] & 1)
        np.testing.assert_array_equal(st.node[:, 2:].numpy(), irows[:, 2:4])
        np.testing.assert_array_equal(st.split.numpy(), rows[:, 1])
        np.testing.assert_array_equal(st.box[:, [0, 1, 2, 4, 5, 6]].numpy(), rows[:, 4:10])
        np.testing.assert_array_equal(st.leaf_win.numpy(), irows[:, 10:12])
        np.testing.assert_array_equal(st.ropes[:, :6].numpy(), irows[:, 12:18])
        assert st.n_nodes == jtab.n_nodes
        assert st.max_steps == max(1, int(st.node[:-1, 1].sum())) * (st.max_depth + 1)
    else:
        st = tree.TreeTables.from_numpy(**tab, device=CPU)
        K = tab["branch"]
        for c in range(3):
            np.testing.assert_array_equal(st.child_box[..., c].numpy(), rows[:, c * K:(c + 1) * K])
            np.testing.assert_array_equal(st.child_box[..., 4 + c].numpy(),
                                          rows[:, (3 + c) * K:(4 + c) * K])
            np.testing.assert_array_equal(st.child_info[..., c].numpy(),
                                          irows[:, (6 + c) * K:(7 + c) * K])
        assert st.n_nodes == jtab.n_nodes and st.stack == (K - 1) * (tab["max_depth"] + 2) + 4
    win = st.win_geom.shape[1]
    wd = tab["win_data"]
    np.testing.assert_array_equal(
        st.win_geom.numpy()[..., :9].transpose(0, 2, 1).reshape(len(wd), 9 * win), wd[:, :9 * win])
    np.testing.assert_array_equal(
        st.win_ids.numpy()[..., :3].transpose(0, 2, 1).reshape(len(wd), 3 * win),
        wd.view(np.int32)[:, 9 * win:])


def agree(jsc, tsc, shoot_fn, o, d, ex=None, top_index=None, tie_share=MAX_TIE_SHARE):
    """The port's shoot against the JAX brute shoot on identical tables."""
    o, d = o.astype(np.float32), d.astype(np.float32)
    kw = {} if top_index is None else {"top_index": top_index}
    hb = jax.tree.map(np.asarray, j_shoot_brute(jsc, jh.Ray.make(o, d, ex), **kw))
    ht = shoot_fn(tsc, t_rays(o, d, ex), top_index=top_index)
    h = hb.hit
    np.testing.assert_array_equal(ht.hit.numpy(), h)
    np.testing.assert_allclose(ht.t.numpy()[h], hb.t[h], rtol=RTOL, atol=ATOL)
    flips = h & (ht.tri_id.numpy() != hb.tri_id)
    assert flips.sum() <= tie_share * len(h), f"{flips.sum()} tie flips"
    return hb, ht


# (port builder, its keywords per scene — the JAX test's parameters)
WALKS = {
    "octree": (partial(octree.build_octree, device=CPU), octree.shoot_octree, {
        "room": dict(max_depth=4, max_tris_per_node=4),
        "soup": dict(max_depth=6, max_tris_per_node=12),
        "hall": dict(max_depth=6, max_tris_per_node=16)}),
    "kdtree": (partial(kdtree.build_kdtree, device=CPU), kdtree.shoot_kdtree, {
        "room": dict(max_depth=8, max_tris_per_node=4),
        "soup": dict(max_depth=12, max_tris_per_node=12),
        "hall": dict(max_depth=14, max_tris_per_node=16)}),
    "kdtree_ropes": (partial(ropes.build_kdtree_ropes, device=CPU), ropes.shoot_kdtree_ropes, {
        "room": dict(max_depth=12, max_tris_per_node=8),
        "soup": dict(max_depth=12, max_tris_per_node=8),
        "hall": dict(max_depth=12, max_tris_per_node=8)}),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("which", sorted(WALKS))
def test_walk_agreement(scenes, rng, which, scene):
    """test_tree_agreement_{room,soup,hall} and test_kdtree_ropes_agreement."""
    _, tt, jsc, tsc = scenes[scene]
    build, shoot, kws = WALKS[which]
    st = build(tt, **kws[scene])
    lo, hi = SCENES[scene][1]
    o = rng.uniform(lo, hi, (200, 3))
    hb, _ = agree(jsc, tsc, lambda s, r, **kw: shoot(s, r, st, **kw), o, rand_dirs(rng, 200),
                  tie_share=HALL_TIE_SHARE if scene == "hall" else MAX_TIE_SHARE)
    if scene == "room":
        assert hb.hit.all()


@pytest.mark.parametrize("split", ["median", "sah"])
@pytest.mark.parametrize("backend", ["kdtree", "kdtree_ropes"])
def test_kdtree_split_policies(scenes, rng, split, backend):
    """Both plane policies x both KD walks == brute force; levels=3 (K = 8)
    too for the stack walk."""
    _, tt, jsc, tsc = scenes["soup"]
    o, d = rng.uniform(-1, 11, (300, 3)), rand_dirs(rng, 300)
    build, shoot, _ = WALKS[backend]
    for kw in ([{}, {"levels": 3}] if backend == "kdtree" else [{}]):
        st = build(tt, max_tris_per_node=8, split=split, **kw)
        agree(jsc, tsc, lambda s, r, **k: shoot(s, r, st, **k), o, d)


@pytest.mark.parametrize("which", sorted(WALKS))
def test_walk_exclusion(scenes, rng, which):
    """Excluding each ray's first hit polygon never returns it again, and
    matches JAX brute with the same exclusions."""
    _, tt, jsc, tsc = scenes["room"]
    build, shoot, _ = WALKS[which]
    st = build(tt, max_depth=8, max_tris_per_node=4)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (50, 3))
    d = rand_dirs(rng, 50)
    h0 = shoot(tsc, t_rays(o, d), st)
    ex = np.stack([h0.poly_id.numpy(), np.full(50, -1)], axis=1).astype(np.int32)
    _, h = agree(jsc, tsc, lambda s, r, **kw: shoot(s, r, st, **kw), o, d, ex=ex)
    assert (h.poly_id.numpy()[h.hit.numpy()] != ex[h.hit.numpy(), 0]).all()


@pytest.mark.parametrize("which", sorted(WALKS))
def test_walk_multi_topology(rng, which):
    """test_tree_multi_topology: one tree over two topologies, filtered by
    top_index at test time."""
    faces = [lambda s: s.shoebox(), lambda s: s.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5))]
    jsc = jh.mesh.build_scene([jh.Topology.build(f(jshapes)) for f in faces])
    tsc = scene_from_numpy({k: np.asarray(v) for k, v in jsc._asdict().items()}, device=CPU)
    tops = [th.Topology.build(f(shapes)) for f in faces]
    build, shoot, _ = WALKS[which]
    st = build(tops, max_depth=8, max_tris_per_node=8)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (80, 3))
    d = rand_dirs(rng, 80)
    for top_index in (None, 0, 1):
        agree(jsc, tsc, lambda s, r, **kw: shoot(s, r, st, **kw), o, d, top_index=top_index)


@pytest.mark.parametrize("which", sorted(WALKS))
def test_walk_boundary_origin_parallel_ray(which):
    """test_grid_boundary_origin_parallel_ray's twin: with pad=0, origins
    exactly ON a root-box face (min-x for the KD trees, min-y for the
    cubified octree), moving parallel to it from outside, still find the
    wall at t = 1; axis-aligned rays through the room centre (on split
    planes) and from a wall hit where brute force does."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    build, shoot, _ = WALKS[which]
    st = build(top, pad=0.0, max_depth=6, max_tris_per_node=2)
    assert st.root_min[1].item() == 0.0
    if which != "octree":
        assert st.root_min[0].item() == 0.0
    sc = top.scene(device=CPU)
    o = [[0.0, -1.0, 1.5], [-1.0, 0.0, 1.5], [2.0, 2.5, 1.5], [2.0, 2.5, 1.5], [2.0, 0.0, 1.5]]
    d = [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    hr = shoot(sc, t_rays(o, d), st)
    assert hr.hit.all()
    np.testing.assert_allclose(hr.t.numpy(), [1.0, 1.0, 1.5, 2.0, 5.0], rtol=1e-5)
    hb = shoot_brute(sc, t_rays(o, d))
    np.testing.assert_array_equal(hr.poly_id.numpy(), hb.poly_id.numpy())


def test_root_leaf():
    """A scene that fits in one leaf: the pseudo-root holds one leaf child
    and nothing is pushed; the rope root is a leaf with six -1 ropes."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    sc = top.scene(device=CPU)
    rng = np.random.default_rng(2)
    o, d = rng.uniform(0.5, 2.5, (64, 3)), rand_dirs(rng, 64)
    ref = shoot_brute(sc, t_rays(o, d))
    oc = octree.build_octree(top, device=CPU)  # 12 tris <= 16 per leaf
    assert oc.child_info[oc.pseudo_root, 0, 0].item() == -1  # the root is a leaf
    kd = ropes.build_kdtree_ropes(top, max_tris_per_node=12, device=CPU)
    assert kd.n_nodes == 1 and (kd.ropes[0] == -1).all()
    for hr, pops in (octree.shoot_octree(sc, t_rays(o, d), oc, with_stats=True),
                     ropes.shoot_kdtree_ropes(sc, t_rays(o, d), kd, with_stats=True)):
        assert torch.equal(hr.tri_id, ref.tri_id)
        assert (pops == 1).all()  # one pop (pseudo-root) / one leaf step


def test_bounds_raise():
    """A stack or step bound smaller than the walk needs raises; nothing is
    truncated."""
    top = th.Topology.build(shapes.random_soup(300, seed=17))
    rng = np.random.default_rng(3)
    rays = t_rays(rng.uniform(-1, 11, (64, 3)), rand_dirs(rng, 64))
    kd = kdtree.build_kdtree(top, max_tris_per_node=4, device=CPU)
    _, _, pops = tree.tree_shoot(rays, kd, with_stats=True)
    assert pops.max() > 3
    with pytest.raises(RuntimeError, match="stack"):
        tree.tree_shoot(rays, kd._replace(stack=2))
    rp = ropes.build_kdtree_ropes(top, max_tris_per_node=4, device=CPU)
    _, _, steps = ropes.ropes_shoot(rays, rp, with_stats=True)
    assert steps.max() > 3
    with pytest.raises(RuntimeError, match="steps"):
        ropes.ropes_shoot(rays, rp._replace(max_steps=3))


def test_converted_tables_walk_alike(scenes, rng):
    """Tables handed over from the JAX builders (convert.tree_from_numpy,
    ropes_from_numpy) walk exactly as the port-built ones."""
    jt, tt, _, tsc = scenes["soup"]
    rays = t_rays(rng.uniform(-1, 11, (128, 3)), rand_dirs(rng, 128))
    a = tree_from_numpy(j_build_octree(jt), device=CPU)
    b = ropes_from_numpy(j_build_ropes(jt), device=CPU)
    for ours, conv, shoot in ((octree.build_octree(tt, device=CPU), a, tree.tree_shoot),
                              (ropes.build_kdtree_ropes(tt, device=CPU), b, ropes.ropes_shoot)):
        x, y = shoot(rays, ours), shoot(rays, conv)
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
