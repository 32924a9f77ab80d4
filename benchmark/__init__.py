"""The benchmark of the PyTorch and CUDA port, ``mi_fieldcalc_tpu_torch``.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or metric sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
driver, ``entries/<entry>.py``) and ``metrics/<metric>.py``.  The plain
reference is ``reference/``; the counts of bytes and operations,
``counts.py``; the published peaks, ``peaks.py``.
"""
