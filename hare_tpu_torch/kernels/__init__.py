"""Hand-written CUDA kernels of the port (``csrc/``) and their build.

K1 ``grid_shoot`` (``csrc/grid_shoot.cu``), K2 ``finalize_hits``
(``csrc/finalize_hits.cu``) and K3 ``energy_histogram``
(``csrc/energy_histogram.cu``) compile into one library at first use; see
:mod:`.build`.  Their wrappers live beside their plain versions:
``accel.voxel.grid_shoot``, ``accel.common.finalize_hits`` and
``trace.bounce.energy_histogram``.
"""
