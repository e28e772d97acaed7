"""The port's counterparts of the repository's ``benchmarks/`` probes.

:mod:`.pallas_probe` and :mod:`.r4_dyngather_probe` run the four Pallas
feasibility probes of ``benchmarks/pallas_probe.py`` and
``benchmarks/r4_dyngather_probe.py`` on an NVIDIA GPU, through the
hand-written kernels of ``kernels/csrc/gather_probe.cu``::

    python -m hare_tpu_torch.benchmarks.pallas_probe
    python -m hare_tpu_torch.benchmarks.r4_dyngather_probe

:mod:`.bench_scene` (the bench scene, each bounce's rays, profiler
times) and :mod:`.bounds` (each kernel's bound) serve ``chip_smoke.py``;
:mod:`.kernel_sweep` times the design candidates of the traversal kernels
(K1, B1, B2, B3), and :mod:`.k1_host` K1's wrapper's host cost, in this
checkout or another.  :mod:`.configs` holds the eval configurations (config
4 so far), :mod:`.repeat_check` reads the bench step's bitwise repeats and
its time, and :mod:`.a3_check` reads A3 against its plain version element
by element and against planted faults.

``import hare_tpu_torch`` does not import this package.
"""
