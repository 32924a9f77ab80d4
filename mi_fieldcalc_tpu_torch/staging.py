"""Host staging: numpy sentinel grids -> device Fields -> the pipeline
kernel -> numpy sentinel grids.

Port of the serving paths of :mod:`mi_fieldcalc_tpu.staging`
(``staging.py:37-83, 136-370, 383-536``).  One request of
:func:`run_derived_fields_np` runs:

1. decode: the 4 input stacks in one ``native.decode_pad_batch`` call into
   the input block of a :class:`HostStager` reused across calls, ``ps``
   after them and the coefficients, map factors and ``fcoriolis`` copied
   behind it; the decode counts decide the ``all_defined`` route;
2. H2D: one copy of the value block and one of the mask block (``uint8``
   viewed as ``bool``), each device tensor a view of them;
3. the kernel: ``derived_fields_fused(stacked=True, all_defined=...)``;
4. D2H and encode: the result planes copied into the stager's reused
   output block a chunk of value planes at a time, and each chunk encoded
   (``native.encode_trim_batch`` with its slice of the ``MASK9`` or
   ``MASK2`` plane map) while the next one is copied; a chunk is never so
   small that its encode runs on less than the codec's whole team.

On CUDA the stager's blocks are page-locked, H2D and D2H run
``non_blocking`` on the stager's own copy streams, and events order them
against the compute stream: the compute stream waits for the upload, a
decode into a block waits for the upload that reads it, and each chunk's
encode waits for its copy.  On the CPU the same steps run on plain host
memory, synchronously.  The arrays returned are always fresh; none is a
view of a reused block.

:func:`stream_derived_fields_np` runs a sequence of requests with the
decode of step i+1 and the encode of step i-1 on two threads while step i
computes, through a pair of stagers.

:func:`run_hlevel_suite_np` serves the hybrid-level conversion suite the
same way (the consumed stacks, ``ps`` and the coefficients in one block,
one suite-kernel launch, the chunked fetch with the suite's mask-plane
map), and :func:`run_vessel_icing_np` the four vessel-icing products from
one ``HostStager(k=11)`` decode of the shared surface fields, the
products in request order (MINCOG and ModStall through their kernels)
fetched plane by plane.

The grid is the logical ``(ny, nx)``: the TPU's padded layout, aligned
re-grid and LEV-packed masks are not ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import native
from .field import UNDEF, Field
from .models.pipeline import DerivedFields, DerivedFieldsStacked
from .ops._harness import not_ported
from .ops.fused_suite import (_build_reqs, _check_coefficients, _consumes,
                              _hlevel_suite_stacked)

__all__ = ["HostStager", "run_derived_fields_np",
           "stream_derived_fields_np", "run_hlevel_suite_np",
           "run_vessel_icing_np"]

#: the rows (planes x levels x ny) up to which the native codec splits a
#: call over fewer than its whole thread team (native/fieldcodec.cc
#: ``num_threads``: 4 threads up to 100000 rows, 8 above)
CODEC_TEAM_ROWS = 100_000


class HostStager:
    """Reusable host blocks for one request at a time: an input block
    (the K decoded ``[K, ..., ny, nx]`` stacks, then ``ps`` and any small
    float32 pieces; values float32 and masks uint8) and an output block
    for the result planes.  Each block is allocated at first use and
    grows only when a request needs more; ``pin`` page-locks them (for
    CUDA devices).  A stager serves one request at a time."""

    def __init__(self, k: int, undef: float = UNDEF, pin: bool = False):
        self.k = int(k)
        self.undef = float(undef)
        self.pin = bool(pin)
        self.values: Optional[np.ndarray] = None
        self.mask: Optional[np.ndarray] = None
        self.counts: List[int] = []
        #: the defined points of the last decoded ``ps`` (None: no ps)
        self.ps_count: Optional[int] = None
        #: CUDA event after the last H2D copy from the input block
        self.uploaded = None
        self._vin: Optional[torch.Tensor] = None
        self._min: Optional[torch.Tensor] = None
        self._out: Optional[torch.Tensor] = None
        self._layout = None
        self._streams: dict = {}

    def _grow(self, attr: str, n: int, dtype: torch.dtype) -> torch.Tensor:
        """The flat host block ``attr`` with room for ``n`` elements."""
        blk = getattr(self, attr)
        if blk is None or blk.numel() < n:
            blk = torch.empty(n, dtype=dtype, pin_memory=self.pin)
            setattr(self, attr, blk)
        return blk

    def streams(self, device: torch.device):
        """This stager's (H2D, D2H) copy streams on ``device``."""
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device),
                                     torch.cuda.Stream(device))
        return self._streams[device]

    def decode(self, *arrays, ps=None, rest=()):
        """Decode the K sentinel arrays (and the ``(ny, nx)`` sentinel
        ``ps``) into the input block and copy the float32 ``rest`` behind
        them; returns ``(values, uint8 mask)``, the K stacks, and sets
        :attr:`counts` (and :attr:`ps_count`).  Waits for the upload that
        last read the block."""
        if len(arrays) != self.k:
            raise ValueError(f"HostStager(k={self.k}) got {len(arrays)}")
        shape = np.shape(arrays[0])
        ny, nx = shape[-2:]
        if ps is not None and np.shape(ps) != (ny, nx):
            raise ValueError(f"ps has shape {np.shape(ps)}, expected "
                             f"({ny}, {nx})")
        rest = [np.asarray(a, np.float32) for a in rest]
        oshape = (self.k,) + tuple(shape)
        n = int(np.prod(oshape))
        nps = 0 if ps is None else ny * nx
        nval = n + nps + sum(a.size for a in rest)
        if self.uploaded is not None:
            self.uploaded.synchronize()
            self.uploaded = None
        vin, vmask = self._vin, self._min
        vals = self._grow("_vin", nval, torch.float32).numpy()
        masks = self._grow("_min", n + nps, torch.uint8).numpy()
        if (self.values is None or self.values.shape != oshape
                or vin is not self._vin or vmask is not self._min):
            self.values = vals[:n].reshape(oshape)
            self.mask = masks[:n].reshape(oshape)
        _, _, self.counts = native.decode_pad_batch(
            arrays, ny, nx, self.undef, out=self.values, mask=self.mask)
        self.ps_count = None
        if ps is not None:
            _, _, (self.ps_count,) = native.decode_pad_batch(
                [ps], ny, nx, self.undef,
                out=vals[n:n + nps].reshape(1, ny, nx),
                mask=masks[n:n + nps].reshape(1, ny, nx))
        off = n + nps
        for a in rest:
            vals[off:off + a.size] = a.reshape(-1)
            off += a.size
        self._layout = (oshape, nps, [a.shape for a in rest], nval)
        return self.values, self.mask

    def upload(self, device: torch.device) -> list:
        """The last decoded request on ``device``: ``[values, mask]`` of
        the K stacks, then ``ps`` (values, mask) where one was decoded,
        then the ``rest`` pieces, each a view of one value copy or one
        mask copy.  On CUDA the copies run on the H2D stream and the
        current stream waits for them; on the CPU they are clones, never
        views of the reused block."""
        oshape, nps, rest_shapes, nval = self._layout
        n = int(np.prod(oshape))
        vsrc, msrc = self._vin[:nval], self._min[:n + nps]
        if device.type == "cpu":
            dv, dm = vsrc.clone(), msrc.clone()
        else:
            compute = torch.cuda.current_stream(device)
            h2d = self.streams(device)[0]
            with torch.cuda.stream(h2d):
                dv = torch.empty(nval, dtype=torch.float32, device=device)
                dm = torch.empty(n + nps, dtype=torch.uint8, device=device)
                dv.copy_(vsrc, non_blocking=True)
                dm.copy_(msrc, non_blocking=True)
                self.uploaded = torch.cuda.Event()
                self.uploaded.record(h2d)
            dv.record_stream(compute)
            dm.record_stream(compute)
            compute.wait_event(self.uploaded)
        dm = dm.view(torch.bool)
        out = [dv[:n].view(oshape), dm[:n].view(oshape)]
        if nps:
            out += [dv[n:n + nps].view(oshape[-2:]),
                    dm[n:n + nps].view(oshape[-2:])]
        off = n + nps
        for s in rest_shapes:
            size = int(np.prod(s))
            out.append(dv[off:off + size].view(s))
            off += size
        return out

    def output_block(self, nbytes: int) -> torch.Tensor:
        """The reused host output block, with room for ``nbytes``."""
        return self._grow("_out", nbytes, torch.uint8)


_TLS = threading.local()


def _stager_cache(k: int, undef: float, pin: bool = False) -> HostStager:
    """The calling thread's reusable stager for ``(k, undef, pin)``: two
    threads never share a block."""
    cache = getattr(_TLS, "stagers", None)
    if cache is None:
        cache = _TLS.stagers = {}
    key = (k, undef, pin)
    if key not in cache:
        cache[key] = HostStager(k, undef, pin)
    return cache[key]


def _resolve_device(device, fn: str = "run_derived_fields_np"
                    ) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{fn}: device='cuda' but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return dev


class Decoded(NamedTuple):
    """A request decoded into ``stager``'s input block: the K stacks
    (numpy views of the block) and the stager that uploads them."""
    values: np.ndarray
    mask: np.ndarray
    stager: HostStager


class Fetched(NamedTuple):
    """Result planes on their way into a stager's output block:
    ``values`` ``[K, ...]`` float32 and ``masks`` ``[M, ...]`` uint8
    (views of the block), ``mask_map[k]`` value plane k's mask plane (-1:
    constant defined), and ``chunks``: ``(lo, hi, event)`` per chunk of
    value planes, the event (None on the CPU) marking its copy done."""
    values: np.ndarray
    masks: np.ndarray
    mask_map: tuple
    chunks: list


def _chunk_size(k: int, plane_shape) -> int:
    """Value planes per D2H chunk: as many chunks as leave each chunk's
    encode above :data:`CODEC_TEAM_ROWS`, at least one.  Smaller chunks
    would overlap more of the copy, but their encode would run on half
    the codec's threads."""
    rows = k * int(np.prod(plane_shape[:-1], dtype=np.int64))
    chunks = max(1, min(k, rows // (CODEC_TEAM_ROWS + 1)))
    return max(1, -(-k // chunks))


def _chunk_plan(mask_map, k: int, chunk: int) -> list:
    """``(lo, hi, mask planes)`` per chunk of ``chunk`` value planes: the
    chunk's value planes and the mask planes it is the first to read."""
    plan, seen = [], {-1}
    for lo in range(0, k, chunk):
        hi = min(k, lo + chunk)
        plan.append((lo, hi, sorted(set(mask_map[lo:hi]) - seen)))
        seen.update(mask_map[lo:hi])
    return plan


def _fetch_planes(values, masks, mask_map, stager: HostStager,
                  chunk: Optional[int] = None) -> Fetched:
    """Copy K value planes and the M mask planes into the stager's output
    block, ``chunk`` value planes at a time (by default
    :func:`_chunk_size`'s), each chunk with the mask planes it is first to
    need.  On CUDA the copies are queued on the D2H stream behind the
    current stream's work, with an event per chunk; on the CPU they run
    now."""
    k, m = len(values), len(masks)
    plane = tuple(values[0].shape) if k else ()
    chunk = _chunk_size(k, plane) if chunk is None else int(chunk)
    npt = int(np.prod(plane))
    blk = stager.output_block(k * npt * 4 + m * npt)
    hv = blk[:k * npt * 4].view(torch.float32).view((k,) + plane)
    hm = blk[k * npt * 4:k * npt * 4 + m * npt].view((m,) + plane)
    dev = values[0].device if k else torch.device("cpu")
    cuda = dev.type == "cuda"
    if cuda:
        d2h = stager.streams(dev)[1]
        d2h.wait_stream(torch.cuda.current_stream(dev))
    chunks = []
    for lo, hi, mask_planes in _chunk_plan(mask_map, k, chunk):
        planes = [(hm[j].view(torch.bool), masks[j]) for j in mask_planes]
        planes += [(hv[i], values[i]) for i in range(lo, hi)]
        if not cuda:
            for dst, src in planes:
                dst.copy_(src)
            chunks.append((lo, hi, None))
            continue
        with torch.cuda.stream(d2h):
            for dst, src in planes:
                dst.copy_(src, non_blocking=True)
                src.record_stream(d2h)
            ev = torch.cuda.Event()
            ev.record(d2h)
        chunks.append((lo, hi, ev))
    return Fetched(hv.numpy(), hm.numpy(), tuple(mask_map), chunks)


def _encode_planes(fetched: Fetched, names, undef: float
                   ) -> Dict[str, np.ndarray]:
    """Encode the fetched planes chunk by chunk, each once its copy is
    done, into fresh sentinel arrays ``{name: plane}``."""
    ny, nx = fetched.values.shape[-2:]
    planes = []
    for lo, hi, ev in fetched.chunks:
        if ev is not None:
            ev.synchronize()
        planes += native.encode_trim_batch(
            fetched.values[lo:hi], fetched.masks, ny, nx,
            fetched.mask_map[lo:hi], undef)
    return dict(zip(names, planes))


def _decode_step(args, stager: HostStager, undef: float):
    """Decode one request on the host into ``stager``; returns
    ``(Decoded, all_defined)``."""
    tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis = args
    nlev, ny, nx = np.shape(tk)
    stager.decode(tk, q, u, v, ps=ps,
                  rest=(alevel, blevel, xmapr, ymapr, fcoriolis))
    # the decode counts prove (or disprove) full definedness: the gate
    # for the kernel's all-defined fast path (the reference's
    # inAllDefined shortcut, FieldCalculations.cc:100)
    all_defined = (stager.ps_count == ny * nx
                   and all(c == nlev * ny * nx for c in stager.counts))
    return Decoded(stager.values, stager.mask, stager), all_defined


def _upload_step(host: Decoded, device: torch.device) -> tuple:
    """Copy a decoded request to ``device``: the pipeline's 10 arguments."""
    dv, dm, psv, psm, *rest = host.stager.upload(device)
    tk, q, u, v = (Field(dv[i], dm[i]) for i in range(4))
    return (tk, q, u, v, Field(psv, psm)) + tuple(rest)


def _compute(staged, all_defined: bool) -> DerivedFieldsStacked:
    from .ops.fused import derived_fields_fused
    return derived_fields_fused(*staged, stacked=True,
                                all_defined=all_defined)


def _fetch(out: DerivedFieldsStacked, stager: HostStager,
           chunk: Optional[int] = None) -> Fetched:
    """Start the chunked fetch of a pipeline result into ``stager``."""
    mask_map = {9: DerivedFieldsStacked.MASK9,
                2: DerivedFieldsStacked.MASK2}[out.masks.shape[0]]
    return _fetch_planes(out.values, out.masks, mask_map, stager, chunk)


def _encode_step(fetched: Fetched, undef: float) -> Dict[str, np.ndarray]:
    return _encode_planes(fetched, DerivedFields._fields, undef)


def run_derived_fields_np(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                          fcoriolis, undef: float = UNDEF,
                          device="cuda") -> Dict[str, np.ndarray]:
    """The 12-output derived-field pipeline from sentinel numpy to sentinel
    numpy: returns ``{name: [nlev, ny, nx]}`` for the 12
    :class:`DerivedFields` outputs.

    ``device="cuda"`` runs the CUDA kernel with page-locked, overlapped
    copies (and raises where CUDA is not available); ``device="cpu"`` runs
    the kernel's plain version.  Fully defined requests, as the decode
    counts show, take the kernel's all-defined path."""
    dev = _resolve_device(device)
    stager = _stager_cache(4, float(undef), dev.type == "cuda")
    host, all_defined = _decode_step(
        (tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis), stager,
        undef)
    out = _compute(_upload_step(host, dev), all_defined)
    return _encode_step(_fetch(out, stager), undef)


def stream_derived_fields_np(steps, undef: float = UNDEF,
                             levpack: Optional[bool] = None,
                             align: Optional[bool] = None, device="cuda"):
    """Drive :func:`run_derived_fields_np` over an iterable of its 10
    arguments (``(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
    fcoriolis)`` per step), yielding one output dict per step, in order,
    equal byte for byte to the single call's.

    While step i computes, one thread decodes step i+1 and another encodes
    step i-1, through a pair of :class:`HostStager` blocks used in turn: a
    block is rewritten only after the copy that reads it has finished.
    ``levpack`` / ``align`` (the TPU link's packed masks and aligned
    re-grid) are not ported; ``None`` reads no environment variable."""
    dev = _resolve_device(device, "stream_derived_fields_np")
    for flag, what in ((levpack, "LEV-packed masks (levpack=True)"),
                       (align, "the aligned re-grid (align=True)")):
        if flag:
            raise not_ported(
                "mi_fieldcalc_tpu.staging.stream_derived_fields_np", what)
    return _stream(iter(steps), float(undef), dev)


def _stream(it, undef: float, dev: torch.device):
    pin = dev.type == "cuda"
    stagers = (HostStager(4, undef, pin), HostStager(4, undef, pin))
    first = next(it, None)
    if first is None:
        return
    with cf.ThreadPoolExecutor(1) as ex_in, \
            cf.ThreadPoolExecutor(1) as ex_out:
        fut = ex_in.submit(_decode_step, first, stagers[0], undef)
        prev = None
        i = 0
        while fut is not None:
            host, all_defined = fut.result()
            nxt = next(it, None)
            fut = None if nxt is None else ex_in.submit(
                _decode_step, nxt, stagers[(i + 1) % 2], undef)
            out = _compute(_upload_step(host, dev), all_defined)
            # the output block of stagers[i % 2] was last read by step
            # i-2's encode, which the previous iteration waited for
            fetched = _fetch(out, stagers[i % 2])
            del out
            if prev is not None:
                yield prev.result()
            prev = ex_out.submit(_encode_step, fetched, undef)
            i += 1
        yield prev.result()


def _suite_decode_step(tk, q, rh, ps, alevel, blevel, reqs,
                       stager: HostStager, undef: float):
    """Check the hybrid coefficients, then decode one suite request on
    the host: the consumed stacks (t, then q and rh where a request reads
    them), ps and the coefficients into the stager.  Returns ``(Decoded,
    all_defined)``."""
    coef = [np.asarray(a, np.float32) for a in (alevel, blevel)]
    _check_coefficients("hlevel_suite_fused", *coef)
    need_q, need_rh = _consumes(reqs)
    stacks = [tk] + ([q] if need_q else []) + ([rh] if need_rh else [])
    nlev, ny, nx = np.shape(tk)
    stager.decode(*stacks, ps=ps, rest=coef)
    all_defined = (stager.ps_count == ny * nx
                   and all(c == nlev * ny * nx for c in stager.counts))
    return Decoded(stager.values, stager.mask, stager), all_defined


def _suite_upload_step(host: Decoded, reqs, device: torch.device) -> tuple:
    """Copy a decoded suite request to ``device``: ``(t, q, rh, ps,
    alevel, blevel)`` with None for an unconsumed q / rh."""
    dv, dm, psv, psm, alevel, blevel = host.stager.upload(device)
    fields = iter(Field(dv[i], dm[i]) for i in range(dv.shape[0]))
    need_q, need_rh = _consumes(reqs)
    t = next(fields)
    q = next(fields) if need_q else None
    rh = next(fields) if need_rh else None
    return (t, q, rh, Field(psv, psm), alevel, blevel)


def _suite_compute(staged, reqs, all_defined: bool):
    """B4 on a staged request, whose coefficients
    :func:`_suite_decode_step` checked on the host."""
    return _hlevel_suite_stacked(*staged, reqs, all_defined=all_defined)


def _suite_fetch(out, stager: HostStager,
                 chunk: Optional[int] = None) -> Fetched:
    """Start the chunked fetch of a :class:`..ops.fused_suite.
    SuiteStacked` with its mask-plane map (-1: constant defined)."""
    return _fetch_planes(out.values, out.masks, out.mask_map, stager, chunk)


def _suite_encode_step(fetched: Fetched, reqs,
                       undef: float) -> Dict[str, np.ndarray]:
    return _encode_planes(fetched, [f"{fam}{c}" for fam, c in reqs], undef)


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

    ``device="cuda"`` runs the suite kernel once with page-locked,
    overlapped copies (and raises where CUDA is not available);
    ``device="cpu"`` runs its plain version.  The coefficients are checked
    on the host before the upload.  Fully defined requests, as the decode
    counts show, take the kernel's all-defined path.  ``align=True`` (the
    TPU's aligned re-grid) is not ported; ``align=None`` reads no
    environment variable."""
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
    stager = _stager_cache(1 + need_q + need_rh, float(undef),
                           dev.type == "cuda")
    host, all_defined = _suite_decode_step(tk, q, rh, ps, alevel, blevel,
                                           reqs, stager, undef)
    out = _suite_compute(_suite_upload_step(host, reqs, dev), reqs,
                         all_defined)
    return _suite_encode_step(_suite_fetch(out, stager), reqs, undef)


#: the vessel-icing products, in the JAX entry's default order
ICING_PRODUCTS = ("overland", "mertins", "modstall", "mincog")


def _icing_upload_step(stager: HostStager, device: torch.device) -> tuple:
    """One copy of the decoded values block and one of the mask block to
    ``device``; the 11 Fields are views of them."""
    dv, dm = stager.upload(device)
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


def _icing_fetch(outs, stager: HostStager,
                 chunk: Optional[int] = None) -> Fetched:
    """Start the chunked fetch of the product Fields, each its own mask
    plane."""
    return _fetch_planes([f.values for f in outs], [f.mask for f in outs],
                         tuple(range(len(outs))), stager, chunk)


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
    stager = _stager_cache(11, float(undef), dev.type == "cuda")
    stager.decode(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, aice,
                  depth)
    fields = _icing_upload_step(stager, dev)
    outs = _icing_products(fields, vs, alpha, zmin, zmax, alt, products)
    return _encode_planes(_icing_fetch(outs, stager), products, undef)
