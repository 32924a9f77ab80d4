"""The general input generator: every field the cells feed the program,
drawn on the device from ``--seed`` by the parameters of a traffic file.

The same seed gives the same inputs.  Each draw is one call over a whole
stack (all members, levels and lead times of a field at once), in float32
with bool masks, on the device the run measures, so set-up stays short.

Distributions, by a traffic file's ``fields`` entry:

* ``["normal", mean, sd]`` and ``["uniform", lo, hi]``;
* ``"undef"``: ``"column"`` leaves one temperature column undefined at
  every level, at ``(ny // 3, nx // 3)``; a number is the share of points
  of each plane that is undefined, drawn independently.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def draw(g: torch.Generator, spec, shape, device) -> torch.Tensor:
    """One float32 stack of ``shape`` by ``spec`` (see the module)."""
    kind, a, b = spec
    if kind == "normal":
        t = torch.randn(shape, generator=g, device=device)
        return t.mul_(float(b)).add_(float(a))
    if kind == "uniform":
        t = torch.rand(shape, generator=g, device=device)
        return t.mul_(float(b) - float(a)).add_(float(a))
    raise ValueError(f"unknown distribution {kind!r}")


def levels(spec, nlev: int, device) -> torch.Tensor:
    """Hybrid coefficients ``["linspace", first, last]`` as ``[nlev]``."""
    kind, a, b = spec
    if kind != "linspace":
        raise ValueError(f"unknown level law {kind!r}")
    return torch.linspace(float(a), float(b), nlev, dtype=torch.float32,
                          device=device)


def undefined_share(g: torch.Generator, share: float, shape,
                    device) -> torch.Tensor:
    """A bool mask with about ``share`` of it False, drawn per point."""
    if share <= 0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return torch.rand(shape, generator=g, device=device) >= share


def pipeline_fields(g, spec: dict, lead: tuple, nlev: int, ny: int, nx: int,
                    device) -> dict:
    """The pipeline's five Fields as ``{name: (values, mask)}``: tk, q, u,
    v of ``lead + (nlev, ny, nx)`` and ps of ``lead + (ny, nx)``."""
    shape3 = tuple(lead) + (nlev, ny, nx)
    shape2 = tuple(lead) + (ny, nx)
    out = {}
    for name in ("tk", "q", "u", "v", "ps"):
        shape = shape2 if name == "ps" else shape3
        out[name] = (draw(g, spec["fields"][name], shape, device),
                     torch.ones(shape, dtype=torch.bool, device=device))
    undef = spec.get("undef")
    if undef == "column":
        out["tk"][1][..., ny // 3, nx // 3] = False
    elif undef:
        for name, (vals, mask) in out.items():
            mask &= undefined_share(g, float(undef), mask.shape, device)
    return out


def pipeline_case(g, config: dict, spec: dict, lead: tuple,
                  device) -> SimpleNamespace:
    """Everything a pipeline call reads, for ``lead`` stacks of lead times
    (and members): ``fields`` (:func:`pipeline_fields`), the hybrid
    coefficients ``alevel``, ``blevel`` and the ``xmapr``, ``ymapr`` and
    ``fcoriolis`` planes of the configuration."""
    nlev, ny, nx = config["levels"], config["ny"], config["nx"]
    fields = pipeline_fields(g, spec, lead, nlev, ny, nx, device)

    def plane(key):
        return torch.full((ny, nx), float(config[key]), device=device)

    return SimpleNamespace(
        fields=fields, alevel=levels(config["alevel"], nlev, device),
        blevel=levels(config["blevel"], nlev, device),
        xmapr=plane("xmapr"), ymapr=plane("ymapr"),
        fcoriolis=plane("fcoriolis"))

