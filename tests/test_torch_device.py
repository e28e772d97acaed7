"""The port's entry points place tensors on the card unless told otherwise.

Every public function that puts tensors on a device takes ``device="cuda"``
as its default: called without ``device`` it returns CUDA tensors where
there is a card and raises where there is none — it never falls back to
the CPU.  Whether there is a card is decided inside each test.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch import convert  # noqa: E402
from hare_tpu_torch.accel import kdtree, octree, ropes, tree, voxel  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402


def room():
    return th.Topology.build(shapes.shoebox(4, 5, 3))


def numpy_scene(top):
    return {k: v.numpy() for k, v in th.build_scene([top], device="cpu")._asdict().items()}


def grid_tables(top):
    return voxel.build_grid_tables(top, domain=4)


# name -> a call without ``device`` that returns a tensor it placed.
ENTRY_POINTS = {
    "SpatialPartition": lambda top: th.SpatialPartition(top).scene.tri_geom,
    "SpatialPartition_octree": lambda top: th.SpatialPartition(top, accel="octree").struct.child_box,
    "Topology.scene": lambda top: top.scene().tri_geom,
    "build_scene": lambda top: th.build_scene([top]).tri_geom,
    "build_voxel_grid": lambda top: voxel.build_voxel_grid(top, domain=4).cell_meta,
    "build_octree": lambda top: th.build_octree(top).child_box,
    "build_kdtree": lambda top: th.build_kdtree(top).child_box,
    "build_kdtree_ropes": lambda top: th.build_kdtree_ropes(top).node,
    "VoxelGrid.from_numpy": lambda top: voxel.VoxelGrid.from_numpy(**grid_tables(top)).win_geom,
    "TreeTables.from_numpy": lambda top: tree.TreeTables.from_numpy(
        **octree.build_octree_tables(top)).win_geom,
    "KDRopes.from_numpy": lambda top: ropes.KDRopes.from_numpy(
        **ropes.build_kdtree_ropes_tables(top)).win_geom,
    "scene_from_numpy": lambda top: convert.scene_from_numpy(numpy_scene(top)).tri_geom,
    "grid_from_numpy": lambda top: convert.grid_from_numpy(
        *(lambda t: (t, t["dims"], t["char_step"], t["max_cell_wins"], t["n_tris"]))(
            grid_tables(top))).cell_meta,
    "tree_from_numpy": lambda top: convert.tree_from_numpy(
        SimpleNamespace(**kdtree.build_kdtree_tables(top))).win_ids,
    "ropes_from_numpy": lambda top: convert.ropes_from_numpy(
        SimpleNamespace(**ropes.build_kdtree_ropes_tables(top))).win_ids,
    "uniform_sphere": lambda top: th.uniform_sphere(8, torch.Generator().manual_seed(0)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    call = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call(room()).device.type == "cuda"
    else:
        # A torch without CUDA asserts; one with CUDA but no device raises.
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call(room())

