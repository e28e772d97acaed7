"""Hand-written CUDA kernels of the port (``csrc/``) and their build.

The main path's traversals — K1 ``grid_shoot``, B1 ``brute_shoot``, B2
``tree_shoot`` (octree, KD-tree) and B3 ``ropes_shoot`` — share one
window-run test (``csrc/windows.cuh``) and hand their winners to K2
``finalize_hits``; K3 ``energy_histogram`` bins the trace.  With the probe
kernels of ``csrc/gather_probe.cu`` they compile into one library at first
use; see :mod:`.build`.  Their wrappers live beside their plain versions
(``accel.voxel``, ``accel.brute``, ``accel.tree``, ``accel.ropes``,
``accel.common``, ``trace.bounce``, ``benchmarks.pallas_probe``).
"""
