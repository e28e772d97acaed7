"""raybench: the benchmark of ``hare_tpu_torch`` on one NVIDIA H100.

``python3 raybench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Every cell is data: a configuration file
(``configs/<name>.json``: the scene as a list of shapes, the structure and
its build parameters, the source, the absorption), a traffic mix
(``traffic/<name>.json``: rays a step, bounces, bins, the ray pool, and
the step's bins, loss and leaf: ``cells.step_of``), the
limits of the output check (``limits/<cell>.json``), and one reader a
metric (``metrics/<metric>.py``).  The yardstick lives here too: the
scene and ray generators (``shapes/``, ``rays.py``), the plain reference
(``reference.py``), the comparison that decides ``correct``
(``judge.py``), the reading of the profiler's trace (``devtrace.py``) and
the frozen operation and byte counts with the card's peaks
(``counts.py``).  Nothing here imports JAX, ``hare_tpu`` or the JAX
package's ``benchmarks``; ``reference.py`` imports nothing of
``hare_tpu_torch`` either.
"""
