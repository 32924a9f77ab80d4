"""The call-storm lab: 22 drop-in calls eagerly against one ``batch()``.

Port of ``tools/perf_lab_batch.py`` (the storm :21-47 and its inputs
:60-68) and of ``tools/perf_lab_batch_cycles.py``'s ``fresh_pair``
(:40-48): BASELINE config 1's workload class, the many small-grid operator
calls of a Diana-style forecast cycle.  Eagerly each call pays the host
dispatch of its PyTorch operations and a pageable copy each way; inside
``batch()`` the storm is one program, on CUDA one CUDA graph replayed per
storm.  ``main`` times both at a size passed in and holds the batch's
outputs byte for byte to the eager calls':

    python -m mi_fieldcalc_tpu_torch.tools.perf_lab_batch \\
        [--device cpu] [--shape 96 128] [--rounds 5]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

__all__ = ["NY", "NX", "inputs", "storm", "fresh_pair", "fetch_all",
           "main"]

#: BASELINE config 1's grid (the TPU lab's size)
NY, NX = 96, 128
UNDEF = 1.0e35
#: the 14 input fields and their ranges (perf_lab_batch.py:64-66)
RANGES = ((240, 260), (250, 275), (260, 290), (5, 95), (5, 95),
          (1e-4, 8e-3), (2800, 3200), (0, 300), (-20, 20), (-20, 20),
          (-40, 40), (-40, 40), (255, 285), (230, 255))


def inputs(ny: int = NY, nx: int = NX, seed: int = 7) -> tuple:
    """The storm's 14 fields ``(t5, t7, t8, rh7, rh8, q8, z7, z10, u8, v8,
    u5, v5, td8, td5)``, each uniform in its range with ``[0, 0]``
    undefined, from one generator in that order."""
    rng = np.random.default_rng(seed)
    out = []
    for lo, hi in RANGES:
        x = rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
        x[0, 0] = UNDEF
        out.append(x)
    return tuple(out)


def storm(fc, g, **kw) -> list:
    """The 22-call mixed storm on the fields ``g``; returns the results in
    call order.  ``fc`` is an api module (the port's or the JAX one);
    ``kw`` goes to every call (``device=`` for the port)."""
    t5, t7, t8, rh7, rh8, q8, z7, z10, u8, v8, u5, v5, td8, td5 = g
    r = []
    r.append(fc.kIndex(t5, t7, rh7, t8, rh8, 500., 700., 850., 1, **kw))
    r.append(fc.ductingIndex(t8, rh8, 850., 1, **kw))
    r.append(fc.showalterIndex(t5, t8, rh8, 500., 850., 1, **kw))
    r.append(fc.boydenIndex(t7, z7, z10, 700., 1000., 1, **kw))
    r.append(fc.sweatIndex(t8, t5, td8, td5, u8, v8, u5, v5, **kw))
    c8 = fc.cvtemp(t8, 2, **kw)
    r.append(c8)
    r.append(fc.abshum(t8, rh8, fc.UNDEF, **kw))
    r.append(fc.windCooling(c8, u8, v8, 2, **kw))
    for c in (1, 3, 5):
        r.append(fc.plevelhum(t8, rh8 if c in (3, 5) else q8, 850., "", c,
                              **kw))
    for c in (1, 3, 4):
        r.append(fc.pleveltemp(t8, 850., "", c, **kw))
    r.append(fc.vectorabs(u8, v8, **kw))
    r.append(fc.underCooledRain(q8, q8, t8, 1e-5, 1e-3, 275.0, **kw))
    for const in (0.5, 2.0):
        r.append(fc.fieldOPERconstant(2, t8, const, **kw))
    r.append(fc.sumFields([t5, t7, t8], **kw))
    r.append(fc.minvalueFields(t5, t8, **kw))
    r.append(fc.maxvalueFields(t5, t8, **kw))
    r.append(fc.absvalueField(u8, **kw))
    return r


def fresh_pair(rng, ny: int = NY, nx: int = NX) -> tuple:
    """The two per-cycle forecast fields ``(t8, rh8)`` as NEW arrays: an
    input cache must miss these and hit everything else."""
    t8 = rng.uniform(260, 290, (ny, nx)).astype(np.float32)
    rh8 = rng.uniform(5, 95, (ny, nx)).astype(np.float32)
    t8[0, 0] = UNDEF
    return t8, rh8


def fetch_all(out) -> list:
    """Every result of a storm on the host (a Deferred flushes)."""
    return [np.asarray(x) for x in out]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev: torch.device, rounds: int) -> float:
    out = []
    for _ in range(rounds):
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="perf_lab_batch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shape", type=int, nargs=2, default=(NY, NX))
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args(argv)
    from .. import api as fc

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("perf_lab_batch: no CUDA device; pass --device "
                         "cpu")
    g = inputs(*a.shape)
    eager = fetch_all(storm(fc, g, device=dev))         # warm-up

    def batched():
        with fc.batch(device=dev):
            out = storm(fc, g, device=dev)
        return fetch_all(out)

    got = batched()                      # record, warm-up and capture
    for i, (e, b) in enumerate(zip(eager, got)):
        if e.tobytes() != b.tobytes():
            raise AssertionError(f"call {i}: the batch differs from the "
                                 f"eager call")
    te = _ms(lambda: fetch_all(storm(fc, g, device=dev)), dev, a.rounds)
    tb = _ms(batched, dev, a.rounds)
    label = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu, host clock")
    print(f"[{label}] {len(eager)} calls at {a.shape[0]}x{a.shape[1]}: "
          f"eager {te:.3f} ms, batch {tb:.3f} ms ({te / tb:.2f}x); "
          f"outputs byte for byte equal")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
