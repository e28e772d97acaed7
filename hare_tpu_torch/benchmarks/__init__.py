"""The port's counterparts of the repository's ``benchmarks/`` probes.

:mod:`.pallas_probe` and :mod:`.r4_dyngather_probe` run the four Pallas
feasibility probes of ``benchmarks/pallas_probe.py`` and
``benchmarks/r4_dyngather_probe.py`` on an NVIDIA GPU, through the
hand-written kernels of ``kernels/csrc/gather_probe.cu``::

    python -m hare_tpu_torch.benchmarks.pallas_probe
    python -m hare_tpu_torch.benchmarks.r4_dyngather_probe

``import hare_tpu_torch`` does not import this package.
"""
