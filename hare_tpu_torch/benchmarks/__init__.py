"""The port's counterparts of the repository's ``benchmarks/`` probes.

:mod:`.pallas_probe` and :mod:`.r4_dyngather_probe` run the four Pallas
feasibility probes of ``benchmarks/pallas_probe.py`` and
``benchmarks/r4_dyngather_probe.py`` on an NVIDIA GPU, through the
hand-written kernels of ``kernels/csrc/gather_probe.cu``::

    python -m hare_tpu_torch.benchmarks.pallas_probe
    python -m hare_tpu_torch.benchmarks.r4_dyngather_probe

:mod:`.bench_scene` (the bench scene, each bounce's rays, profiler
times) and :mod:`.bounds` (each kernel's bound) serve ``chip_smoke.py``;
:mod:`.k1_sweep` times K1's design candidates, and :mod:`.k1_host` its
wrapper's host cost, in this checkout or another.

``import hare_tpu_torch`` does not import this package.
"""
