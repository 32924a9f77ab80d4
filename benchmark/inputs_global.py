"""Inputs on a global regular latitude-longitude grid: the hybrid level law
of a configuration's ``hybrid_law``, the map factors and Coriolis
parameter of the sphere, and a surface pressure drawn apart in the rows
south of a latitude (:mod:`benchmark.inputs` gives only ``linspace`` laws
and constant map factors).

Row 0 is the north pole and row ``ny - 1`` the south pole; longitudes
start at 0 in steps of ``360 / nx`` degrees, so the map factors vary by
row alone.  Laws and factors are worked out in float64 and stored as
float32.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from . import inputs


def latitudes_deg(ny: int) -> np.ndarray:
    """The rows' latitudes, 90 at row 0 to -90 at row ``ny - 1``."""
    return 90.0 - 180.0 * np.arange(ny, dtype=np.float64) / (ny - 1)


def hybrid_law(config: dict) -> tuple:
    """``(A, B)`` in float64 of the configuration's ``levels`` full
    levels, top first: ``knee_level + 1`` pure-pressure levels whose A
    rises geometrically from ``top_hpa`` to ``knee_hpa`` (B = 0), then
    x = (k - knee) / (levels - 1 - knee), B = x^e and A = knee_hpa +
    (surface_hpa - knee_hpa) x - surface_hpa x^e, so that p = A + B ps is
    ``knee_hpa + (surface_hpa - knee_hpa) x`` at ``ps = surface_hpa``, A
    returns to 0 at the lowest level and B reaches 1 there."""
    law, nlev = config["hybrid_law"], int(config["levels"])
    knee, e = int(law["knee_level"]), float(law["b_exponent"])
    top, pk, ps0 = (float(law[k]) for k in ("top_hpa", "knee_hpa",
                                             "surface_hpa"))
    k = np.arange(nlev, dtype=np.float64)
    x = np.clip((k - knee) / (nlev - 1 - knee), 0.0, None)
    upper = k <= knee
    a = np.where(upper, top * (pk / top) ** (np.minimum(k, knee) / knee),
                 pk + (ps0 - pk) * x - ps0 * x ** e)
    b = np.where(upper, 0.0, x ** e)
    return a, b


def hybrid_levels(config: dict, device) -> tuple:
    """:func:`hybrid_law` as float32 ``[levels]`` tensors on ``device``."""
    return tuple(torch.as_tensor(c.astype(np.float32), device=device)
                 for c in hybrid_law(config))


def map_planes(config: dict, ny: int, nx: int, device) -> tuple:
    """``xmapr``, ``ymapr`` and ``fcoriolis`` as float32 ``[ny, nx]``:
    1/(a cos(lat) dlon), 1/(a dlat) and 2 omega sin(lat); the pole rows
    take the ``xmapr`` of their neighbouring row."""
    lat = np.radians(latitudes_deg(ny))
    a = float(config["earth_radius_m"])
    dlon, dlat = 2.0 * math.pi / nx, math.pi / (ny - 1)
    cos = np.cos(lat)
    cos[0], cos[-1] = cos[1], cos[-2]
    rows = (1.0 / (a * cos * dlon), np.full(ny, 1.0 / (a * dlat)),
            2.0 * float(config["omega_per_s"]) * np.sin(lat))
    return tuple(torch.as_tensor(r.astype(np.float32), device=device)
                 .reshape(ny, 1).expand(ny, nx).contiguous() for r in rows)


def south_rows(ny: int, south_of_deg: float) -> slice:
    """The rows whose latitude lies south of ``south_of_deg``: the last
    rows of the grid."""
    first = int(np.count_nonzero(latitudes_deg(ny) >= south_of_deg))
    return slice(first, ny)


def isobaric_case(g, config: dict, spec: dict, lead: tuple,
                  device) -> SimpleNamespace:
    """Everything an isobaric call reads, for ``lead`` stacks of lead
    times: ``fields`` (:func:`benchmark.inputs.pipeline_fields`, every
    point defined unless ``spec`` says otherwise), with ps drawn again from
    ``spec["ps_south"]["ps"]`` in :func:`south_rows`; the hybrid
    coefficients, the map planes and the configuration's ``plevels``."""
    nlev, ny, nx = config["levels"], config["ny"], config["nx"]
    fields = inputs.pipeline_fields(g, spec, lead, nlev, ny, nx, device)
    south = spec["ps_south"]
    rows = south_rows(ny, float(south["south_of_deg"]))
    ps = fields["ps"][0]
    ps[..., rows, :] = inputs.draw(g, south["ps"], ps[..., rows, :].shape,
                                   device)
    alevel, blevel = hybrid_levels(config, device)
    xmapr, ymapr, fcoriolis = map_planes(config, ny, nx, device)
    return SimpleNamespace(
        fields=fields, alevel=alevel, blevel=blevel, xmapr=xmapr,
        ymapr=ymapr, fcoriolis=fcoriolis,
        plevels=tuple(float(p) for p in config["plevels"]))
