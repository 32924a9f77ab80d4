"""Host staging: numpy sentinel grids -> device Fields -> the pipeline
kernel -> numpy sentinel grids.

Port of the serving paths of :mod:`mi_fieldcalc_tpu.staging`
(``staging.py:37-83, 136-298, 383-536``).  One request of
:func:`run_derived_fields_np` runs:

1. decode: the 4 input stacks in one ``native.decode_pad_batch`` call into
   a :class:`HostStager` block reused across same-shape calls, and ``ps``
   through ``native.decode_pad``; the decode counts decide the
   ``all_defined`` route;
2. H2D: values and ``uint8`` masks (viewed as ``bool``) to the device;
3. the kernel: ``derived_fields_fused(stacked=True, all_defined=...)``;
4. D2H and encode: ``native.encode_trim_batch`` with the ``MASK9`` or
   ``MASK2`` plane map.

:func:`run_hlevel_suite_np` serves the hybrid-level conversion suite the
same way: the consumed stacks in one ``decode_pad_batch``, ``ps``, H2D,
one suite-kernel launch, D2H and one ``encode_trim_batch`` with the
suite's mask-plane map.

The grid is the logical ``(ny, nx)``: the TPU's padded layout and aligned
re-grid are not ported.  ``stream_derived_fields_np`` (copy/compute
overlap on CUDA streams) is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import native
from .field import UNDEF, Field
from .models.pipeline import DerivedFields, DerivedFieldsStacked
from .ops._harness import not_ported
from .ops.fused_suite import _build_reqs, _consumes, hlevel_suite_stacked

__all__ = ["HostStager", "run_derived_fields_np", "run_hlevel_suite_np"]


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


def _resolve_device(device, fn: str = "run_derived_fields_np"
                    ) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{fn}: device='cuda' but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: unsupported device {dev}")
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


def _fetch(out):
    """Device result (a :class:`DerivedFieldsStacked` or a suite's
    ``SuiteStacked``) -> numpy ``(values, uint8 masks)``."""
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


def _suite_decode_step(tk, q, rh, ps, alevel, blevel, reqs,
                       stager: HostStager, undef: float):
    """Decode one suite request on the host: the consumed stacks (t, then
    q and rh where a request reads them) in one batch into the reused
    stager, and ps.  Returns ``(host, all_defined)``."""
    need_q, need_rh = _consumes(reqs)
    stacks = [tk] + ([q] if need_q else []) + ([rh] if need_rh else [])
    nlev, ny, nx = np.shape(tk)
    vals, mask = stager.decode(*stacks)
    psv, psm, ps_ndef = native.decode_pad(ps, ny, nx, undef)
    all_defined = (ps_ndef == ny * nx
                   and all(c == nlev * ny * nx for c in stager.counts))
    coef = [np.ascontiguousarray(a, np.float32) for a in (alevel, blevel)]
    return (vals, mask, psv, psm.view(np.uint8), coef), all_defined


def _suite_upload_step(host, reqs, device: torch.device) -> tuple:
    """Copy a decoded suite request to ``device``: ``(t, q, rh, ps,
    alevel, blevel)`` with None for an unconsumed q / rh."""
    vals, mask, psv, psm, coef = host
    dv = torch.from_numpy(vals).to(device, copy=True)
    dm = torch.from_numpy(mask).to(device, copy=True).view(torch.bool)
    fields = iter(Field(dv[i], dm[i]) for i in range(dv.shape[0]))
    need_q, need_rh = _consumes(reqs)
    t = next(fields)
    q = next(fields) if need_q else None
    rh = next(fields) if need_rh else None
    ps = Field(torch.from_numpy(psv).to(device, copy=True),
               torch.from_numpy(psm).to(device, copy=True).view(torch.bool))
    return (t, q, rh, ps) + tuple(
        torch.from_numpy(a).to(device, copy=True) for a in coef)


def _suite_compute(staged, reqs, all_defined: bool):
    return hlevel_suite_stacked(*staged, reqs, all_defined=all_defined)


def _suite_encode_step(values, masks, mask_map, reqs,
                       undef: float) -> Dict[str, np.ndarray]:
    """One encode of a fetched :class:`..ops.fused_suite.SuiteStacked`
    with its mask-plane map (-1: constant defined)."""
    ny, nx = values.shape[-2:]
    planes = native.encode_trim_batch(values, masks, ny, nx, mask_map,
                                      undef)
    return {f"{fam}{c}": a for (fam, c), a in zip(reqs, planes)}


def run_hlevel_suite_np(tk, q, rh, ps, alevel, blevel,
                        temps=(), hums_q=(), hums_rh=(),
                        thes=(), ducts_q=(), ducts_rh=(),
                        undef: float = UNDEF,
                        align: Optional[bool] = None,
                        device="cuda") -> Dict[str, np.ndarray]:
    """The hybrid-level conversion suite from sentinel numpy to sentinel
    numpy: the drop-in for one ``hlevel*`` call per product.

    Inputs: ``[nlev, ny, nx]`` sentinel stacks (``q`` / ``rh`` may be None
    where no requested mode consumes them), the ``(ny, nx)`` surface
    pressure and the ``[nlev]`` hybrid coefficients; request tuples as
    :func:`..ops.fused_suite.hlevel_suite_fused`.  Returns
    ``{"temp3": ..., "hum_q1": ..., ...}`` keyed by family and compute, in
    request order.

    ``device="cuda"`` runs the suite kernel once (and raises where CUDA is
    not available); ``device="cpu"`` runs its plain version.  Fully
    defined requests, as the decode counts show, take the kernel's
    all-defined path.  ``align=True`` (the TPU's aligned re-grid) is not
    ported; ``align=None`` reads no environment variable."""
    dev = _resolve_device(device, "run_hlevel_suite_np")
    if align:
        raise not_ported("mi_fieldcalc_tpu.staging.run_hlevel_suite_np",
                         "the aligned re-grid (align=True)")
    reqs = _build_reqs("run_hlevel_suite_np", temps, hums_q, hums_rh,
                       thes, ducts_q, ducts_rh)
    need_q, need_rh = _consumes(reqs)
    if need_q and q is None:
        raise ValueError("run_hlevel_suite_np: a requested mode consumes q "
                         "but q is None")
    if need_rh and rh is None:
        raise ValueError("run_hlevel_suite_np: a requested mode consumes rh "
                         "but rh is None")
    stager = _stager_cache(1 + need_q + need_rh, float(undef))
    host, all_defined = _suite_decode_step(tk, q, rh, ps, alevel, blevel,
                                           reqs, stager, undef)
    out = _suite_compute(_suite_upload_step(host, reqs, dev), reqs,
                         all_defined)
    return _suite_encode_step(*_fetch(out), out.mask_map, reqs, undef)
