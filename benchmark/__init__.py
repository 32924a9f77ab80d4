"""The benchmark of the PyTorch and CUDA port, ``mi_fieldcalc_tpu_torch``.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or metric sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
driver, ``entries/<entry>.py``) and ``metrics/<metric>.py``.  The plain
reference is ``reference/``; the counts of bytes and operations,
``counts.py``; the published peaks, ``peaks.py``.

A configuration is added as a new ``configs/<config>.json`` that carries
its own ``cpu_test`` (the keys the CPU tests override and their small
values), plus its entries in ``BENCHMARK.json``: its ``configs`` entry,
its cells under ``workloads`` and their per-layer metrics.  A new cell
joins an end-to-end time metric it reports (``summary_ms``, ``step_ms``)
by adding its name to that metric's ``workloads``.  No file already here
changes (``tests/test_bench_cells.py`` proves it on a copy).
"""
