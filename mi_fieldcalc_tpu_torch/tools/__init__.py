"""The port's measurement labs: each probe kernel of ``csrc/probes.cu``
with its plain PyTorch version, its wrapper and the lab's ``main``.

Named after the JAX-era scripts they port, so that a reader finds each
counterpart: :mod:`.bench_copy` (P1, B1's bytes at the best rate the card
gives them; ``bench.py``'s copy probe), :mod:`.perf_lab_dma` (P2),
:mod:`.perf_lab_element` (P3) and :mod:`.probe_mincog_kernel` (P4).  Run
one on the card with ``python -m mi_fieldcalc_tpu_torch.tools.<name>``.
Nothing on the serving path imports this package.
"""
