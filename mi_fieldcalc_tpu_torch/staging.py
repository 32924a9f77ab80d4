"""Host staging: numpy sentinel grids -> device Fields -> the pipeline
kernel -> numpy sentinel grids.

Port of the serving path of :mod:`mi_fieldcalc_tpu.staging`
(``staging.py:37-83, 136-298``).  One request of
:func:`run_derived_fields_np` runs:

1. decode: the 4 input stacks in one ``native.decode_pad_batch`` call into
   a :class:`HostStager` block reused across same-shape calls, and ``ps``
   through ``native.decode_pad``; the decode counts decide the
   ``all_defined`` route;
2. H2D: values and ``uint8`` masks (viewed as ``bool``) to the device;
3. the kernel: ``derived_fields_fused(stacked=True, all_defined=...)``;
4. D2H and encode: ``native.encode_trim_batch`` with the ``MASK9`` or
   ``MASK2`` plane map.

The grid is the logical ``(ny, nx)``: the TPU's padded layout is not
ported.  ``stream_derived_fields_np`` (copy/compute overlap on CUDA
streams) is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import native
from .field import UNDEF, Field
from .models.pipeline import DerivedFields, DerivedFieldsStacked

__all__ = ["HostStager", "run_derived_fields_np"]


class HostStager:
    """Reusable host buffers for K same-shape sentinel inputs: one
    contiguous ``[K, ..., ny, nx]`` (values, uint8 mask) block, allocated
    at first use and reused while the shape stays the same."""

    def __init__(self, k: int, undef: float = UNDEF):
        self.k = int(k)
        self.undef = float(undef)
        self.values: Optional[np.ndarray] = None
        self.mask: Optional[np.ndarray] = None
        self.counts: List[int] = []

    def decode(self, *arrays):
        """Decode the K sentinel arrays into the reused block; returns
        ``(values, uint8 mask)`` and sets :attr:`counts`."""
        if len(arrays) != self.k:
            raise ValueError(f"HostStager(k={self.k}) got {len(arrays)}")
        a0 = np.asarray(arrays[0])
        oshape = (self.k,) + a0.shape
        if self.values is None or self.values.shape != oshape:
            self.values = np.empty(oshape, np.float32)
            self.mask = np.empty(oshape, np.uint8)
        ny, nx = a0.shape[-2:]
        _, _, self.counts = native.decode_pad_batch(
            arrays, ny, nx, self.undef, out=self.values, mask=self.mask)
        return self.values, self.mask


_TLS = threading.local()


def _stager_cache(k: int, undef: float) -> HostStager:
    """The calling thread's reusable stager for ``(k, undef)``."""
    cache = getattr(_TLS, "stagers", None)
    if cache is None:
        cache = _TLS.stagers = {}
    if (k, undef) not in cache:
        cache[(k, undef)] = HostStager(k, undef)
    return cache[(k, undef)]


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_derived_fields_np: device='cuda' but CUDA is "
                           "not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"run_derived_fields_np: unsupported device {dev}")
    return dev


def _decode_step(args, stager: HostStager, undef: float):
    """Decode one request on the host; returns ``(host, all_defined)``
    where ``host`` holds the numpy pieces :func:`_upload_step` moves."""
    tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis = args
    nlev, ny, nx = np.shape(tk)
    vals, mask = stager.decode(tk, q, u, v)
    psv, psm, ps_ndef = native.decode_pad(ps, ny, nx, undef)
    # the decode counts prove (or disprove) full definedness: the gate
    # for the kernel's all-defined fast path (the reference's
    # inAllDefined shortcut, FieldCalculations.cc:100)
    all_defined = (ps_ndef == ny * nx
                   and all(c == nlev * ny * nx for c in stager.counts))
    rest = [np.ascontiguousarray(a, np.float32)
            for a in (alevel, blevel, xmapr, ymapr, fcoriolis)]
    return (vals, mask, psv, psm.view(np.uint8), rest), all_defined


def _upload_step(host, device: torch.device) -> tuple:
    """Copy a decoded request to ``device``: the pipeline's 10 arguments."""
    vals, mask, psv, psm, rest = host
    # one copy each for the values and mask blocks; never a view of the
    # stager's reused host buffers
    dv = torch.from_numpy(vals).to(device, copy=True)
    dm = torch.from_numpy(mask).to(device, copy=True).view(torch.bool)
    tk, q, u, v = (Field(dv[i], dm[i]) for i in range(4))
    ps = Field(torch.from_numpy(psv).to(device, copy=True),
               torch.from_numpy(psm).to(device, copy=True).view(torch.bool))
    return (tk, q, u, v, ps) + tuple(
        torch.from_numpy(a).to(device, copy=True) for a in rest)


def _compute(staged, all_defined: bool) -> DerivedFieldsStacked:
    from .ops.fused import derived_fields_fused
    return derived_fields_fused(*staged, stacked=True,
                                all_defined=all_defined)


def _fetch(out: DerivedFieldsStacked):
    """Device result -> numpy ``(values, uint8 masks)``."""
    return (out.values.cpu().numpy(),
            out.masks.cpu().numpy().view(np.uint8))


def _encode_step(values, masks, undef: float) -> Dict[str, np.ndarray]:
    mask_map = {9: DerivedFieldsStacked.MASK9,
                2: DerivedFieldsStacked.MASK2}[masks.shape[0]]
    ny, nx = values.shape[-2:]
    planes = native.encode_trim_batch(values, masks, ny, nx, mask_map,
                                      undef)
    return dict(zip(DerivedFields._fields, planes))


def run_derived_fields_np(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                          fcoriolis, undef: float = UNDEF,
                          device="cuda") -> Dict[str, np.ndarray]:
    """The 12-output derived-field pipeline from sentinel numpy to sentinel
    numpy: returns ``{name: [nlev, ny, nx]}`` for the 12
    :class:`DerivedFields` outputs.

    ``device="cuda"`` runs the CUDA kernel (and raises where CUDA is not
    available); ``device="cpu"`` runs the kernel's plain version.  Fully
    defined requests, as the decode counts show, take the kernel's
    all-defined path."""
    dev = _resolve_device(device)
    stager = _stager_cache(4, float(undef))
    host, all_defined = _decode_step(
        (tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis), stager,
        undef)
    out = _compute(_upload_step(host, dev), all_defined)
    return _encode_step(*_fetch(out), undef)
