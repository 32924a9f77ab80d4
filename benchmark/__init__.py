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

A cell on one chip runs in ``run.py``'s own process.  A cell whose
``chips`` is N > 1 runs as N processes, one a card (``ranks.py``): each
rank builds the cell's entry on ``cuda:<rank>`` under torchrun's
environment, the entry joins the process group itself, and every rank
runs the same units, rank 0's clock deciding each; rank 0 reports them as
one run (``count`` N, the fullest card's peak, each compared number's
largest value over the ranks, its own spans and trace for the per-layer
metrics).  An entry of such a cell keeps one rule: every rank runs the
same units and the same collectives in the same order.  ``readings.py``
launches the ranks the same way.
"""
