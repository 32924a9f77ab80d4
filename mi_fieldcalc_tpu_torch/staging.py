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

:func:`run_vessel_icing_np` serves the four vessel-icing products from
one ``HostStager(k=11)`` decode of the shared surface fields: one H2D copy
of the values block and one of the mask block, the products in request
order (MINCOG and ModStall through their kernels), the results stacked
into one device buffer, one D2H copy and one ``encode_trim_batch``.

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

__all__ = ["HostStager", "run_derived_fields_np", "run_hlevel_suite_np",
           "run_vessel_icing_np"]


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


#: the vessel-icing products, in the JAX entry's default order
ICING_PRODUCTS = ("overland", "mertins", "modstall", "mincog")


def _icing_upload_step(host, device: torch.device) -> tuple:
    """One copy of the decoded values block and one of the mask block to
    ``device``; the 11 Fields are views of them."""
    vals, mask = host
    dv = torch.from_numpy(vals).to(device, copy=True)
    dm = torch.from_numpy(mask).to(device, copy=True).view(torch.bool)
    return tuple(Field(dv[i], dm[i]) for i in range(dv.shape[0]))


def _icing_products(fields, vs, alpha, zmin, zmax, alt, products) -> list:
    """The requested products as Fields, in request order (MINCOG and
    ModStall through their kernels on CUDA tensors)."""
    from .ops.icing import vessel_icing_mertins, vessel_icing_overland
    from .ops.icing_fused import (vessel_icing_mincog_fused,
                                  vessel_icing_modstall_fused)
    sal, _, xw, yw, at, _, sst, _, _, aice, _ = fields
    outs = []
    for prod in products:
        if prod == "overland":
            outs.append(vessel_icing_overland(at, sst, xw, yw, sal, aice))
        elif prod == "mertins":
            outs.append(vessel_icing_mertins(at, sst, xw, yw, sal, aice))
        elif prod == "modstall":
            outs.append(vessel_icing_modstall_fused(*fields, vs, alpha,
                                                    zmin, zmax))
        else:
            outs.append(vessel_icing_mincog_fused(*fields, vs, alpha, zmin,
                                                  zmax, alt))
    return outs


def _icing_stack(outs) -> torch.Tensor:
    """The products stacked into one device byte buffer: K float32 value
    planes, then K mask planes, so one D2H copy fetches both."""
    k = len(outs)
    shape = tuple(outs[0].values.shape)
    n = k * outs[0].values.numel()
    buf = torch.empty(5 * n, dtype=torch.uint8,
                      device=outs[0].values.device)
    torch.stack([f.values for f in outs],
                out=buf[:4 * n].view(torch.float32).view((k,) + shape))
    torch.stack([f.mask for f in outs],
                out=buf[4 * n:].view(torch.bool).view((k,) + shape))
    return buf


def _icing_fetch(buf, k: int, shape) -> tuple:
    """One D2H copy of the product buffer -> numpy ``(values, uint8
    masks)``, each ``[k, ny, nx]``."""
    host = buf.cpu().numpy()
    n = k * int(np.prod(shape))
    return (host[:4 * n].view(np.float32).reshape((k,) + tuple(shape)),
            host[4 * n:].reshape((k,) + tuple(shape)))


def _icing_encode_step(values, masks, products,
                       undef: float) -> Dict[str, np.ndarray]:
    ny, nx = values.shape[-2:]
    planes = native.encode_trim_batch(values, masks, ny, nx,
                                      tuple(range(len(products))), undef)
    return dict(zip(products, planes))


def run_vessel_icing_np(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                        pw, aice, depth,
                        vs: float, alpha: float, zmin: float, zmax: float,
                        alt: int = 1, products=ICING_PRODUCTS,
                        undef: float = UNDEF,
                        align: Optional[bool] = None,
                        device="cuda") -> Dict[str, np.ndarray]:
    """All requested vessel-icing products from one decode of the shared
    inputs: the production form of the reference's per-product
    ``vesselIcing*`` calls.

    Inputs: ``(ny, nx)`` sentinel arrays (the ModStall / MINCOG set;
    Overland and Mertins read ``airtemp, sst, x_wind, y_wind, sal, aice``);
    scalars as :func:`.ops.icing.vessel_icing_mincog`.  Returns
    ``{product: sentinel array}`` in request order.

    ``device="cuda"`` runs the MINCOG and ModStall kernels once each per
    request (and raises where CUDA is not available); ``device="cpu"``
    runs their plain versions.  ``align=True`` (the TPU's aligned re-grid)
    is not ported; ``align=None`` reads no environment variable."""
    dev = _resolve_device(device, "run_vessel_icing_np")
    for prod in products:
        if prod not in ICING_PRODUCTS:
            raise ValueError(f"run_vessel_icing_np: unknown product "
                             f"{prod!r} (known: {ICING_PRODUCTS})")
    if align:
        raise not_ported("mi_fieldcalc_tpu.staging.run_vessel_icing_np",
                         "the aligned re-grid (align=True)")
    products = tuple(dict.fromkeys(products))
    if not products:
        return {}
    arrays = (sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, aice,
              depth)
    stager = _stager_cache(11, float(undef))
    fields = _icing_upload_step(stager.decode(*arrays), dev)
    buf = _icing_stack(_icing_products(fields, vs, alpha, zmin, zmax, alt,
                                       products))
    host = _icing_fetch(buf, len(products), fields[0].values.shape)
    return _icing_encode_step(*host, products, undef)
