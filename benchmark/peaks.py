"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  NVIDIA's data sheet for the H100
SXM: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores
(a fused multiply-add counted as two), both at the full 700 W."""

from __future__ import annotations

#: card name -> (memory bytes/s, float32 operations/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


def bound_s(name: str, nbytes: float, ops: float) -> float:
    """The least time for work of ``nbytes`` moved once and ``ops``
    float32 operations: the larger of the two at the published rates.
    Raises for a card the table does not hold (a CPU has no device
    peak)."""
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}")
    bw, flops = PEAKS[name]
    return max(nbytes / bw, ops / flops)
