"""End-to-end tour of the PyTorch port: derived forecast products through
every surface, on an NVIDIA GPU.

The counterpart of ``examples/forecast_products.py``, section for section:

1. the drop-in numpy API (what existing mi-fieldcalc users call),
2. the native Field surface, all levels at once,
3. the sharded fused pipeline over a grid of processes,
4. the hybrid-level suite: a family of products in one kernel pass,
5. a call storm recorded and run as one device program,
6. forecast cycles with device-resident inputs,
7. a subset fetch of a storm's outputs,
8. the aligned ingest: a ragged grid re-gridded onto the aligned product
   grid (``align=True``).

    python examples/forecast_products_torch.py                # the card
    python examples/forecast_products_torch.py --device cpu   # CPU: the
                                                              # plain versions
    torchrun --nproc-per-node=N examples/forecast_products_torch.py

Without CUDA and without ``--device cpu`` it raises.  Under ``torchrun``
section 3 cuts the grid over the ranks and every rank runs the other
sections on its own card; rank 0 prints.  :func:`main` also returns the
numbers it prints.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch


def synthetic_state(nlev=10, ny=96, nx=128, seed=0):
    """A vaguely atmospheric synthetic model state on hybrid levels (the
    JAX tour's, value for value)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(-1, 1, ny)[:, None]
    xx = np.linspace(-1, 1, nx)[None, :]
    blob = np.exp(-(yy ** 2 + xx ** 2) * 3).astype(np.float32)
    lev = np.linspace(0.3, 1.0, nlev)[:, None, None].astype(np.float32)
    tk = 220 + 70 * lev + 8 * blob[None] \
        + rng.normal(0, 0.5, (nlev, ny, nx)).astype(np.float32)
    q = (1e-3 * lev * (1 + blob[None])).astype(np.float32)
    u = 15 * (1 - lev) + 5 * np.gradient(blob, axis=0)[None]
    v = 5 * np.gradient(blob, axis=1)[None] * np.ones_like(lev)
    ps = (1000 + 12 * blob).astype(np.float32)
    alevel = np.linspace(20.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.25, 1.0, nlev).astype(np.float32)
    mapr = np.full((ny, nx), 4e-7, np.float32)
    fcor = np.full((ny, nx), 1.2e-4, np.float32)
    # a patch of missing data (e.g. satellite gap)
    tk[:, 10:14, 20:26] = 1.0e35
    return (tk.astype(np.float32), q, u.astype(np.float32),
            v.astype(np.float32), ps, alevel, blevel, mapr, fcor)


def _rank_device(dev: torch.device) -> torch.device:
    """Join the process group torchrun set up, if there is one and it is
    not joined yet (section 3 cuts the grid over its ranks); returns this
    rank's device, or ``dev`` in a single process."""
    import torch.distributed as dist

    from mi_fieldcalc_tpu_torch.parallel import distributed

    if not dist.is_initialized() and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        distributed.initialize(device=dev.type)
    if dist.is_initialized():
        dev = distributed.device() or dev
    return dev


def main(device="cuda", state=None) -> dict:
    """Run the tour on ``device``; returns the numbers it prints."""
    import torch.distributed as dist

    dev = _rank_device(torch.device(device))
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def say(line: str) -> None:
        if rank0:
            print(line)

    tk, q, u, v, ps, alevel, blevel, mapr, fcor = (
        synthetic_state() if state is None else state)
    ny, nx = tk.shape[-2:]
    res = {}

    # -- 1. drop-in numpy API (one level at a time, like the reference) --
    import mi_fieldcalc_tpu_torch.api as fc
    rh0 = fc.hlevelhum(tk[-1], q[-1], ps, float(alevel[-1]),
                       float(blevel[-1]), "kelvin", 1, device=dev)
    chill = fc.windCooling(tk[-1], u[-1], v[-1], 1, device=dev)
    res["rh_mean"] = float(np.nanmean(rh0[rh0 < 1e34]))
    res["chill_min"] = float(chill[chill < 1e34].min())
    say(f"lowest-level RH%:   mean {res['rh_mean']:6.1f}")
    say(f"wind chill (K):     min  {res['chill_min']:6.1f}")

    # -- 2. native surface: all levels at once on the device -------------
    from mi_fieldcalc_tpu_torch import from_sentinel
    from mi_fieldcalc_tpu_torch.models import (derived_fields,
                                               derived_fields_isobaric)

    fields = tuple(from_sentinel(a, device=dev) for a in (tk, q, u, v, ps))
    coefs = tuple(torch.as_tensor(a, device=dev) for a in (alevel, blevel))
    geo = tuple(torch.as_tensor(a, device=dev) for a in (mapr, mapr, fcor))

    out = derived_fields(*fields, *coefs, *geo)
    thetae = out.thetae.to_sentinel().cpu().numpy()
    res["thetae_max"] = float(thetae[thetae < 1e34].max())
    res["thetae_undef"] = int((thetae >= 1e34).sum())
    say(f"theta_e (K):        max  {res['thetae_max']:6.1f} "
        f"({res['thetae_undef']} undef pts propagate the gap)")

    iso = derived_fields_isobaric(*fields, *coefs, *geo,
                                  plevels=(850.0, 500.0))
    res["td850_mean"] = float(iso.td.values[0][iso.td.mask[0]].mean())
    say(f"850 hPa dewpoint:   mean {res['td850_mean']:6.1f} K")

    # -- 3. sharded: same math, domain-decomposed over the processes -----
    from mi_fieldcalc_tpu_torch.parallel import distributed, grid_mesh
    from mi_fieldcalc_tpu_torch.parallel.fused import (
        derived_fields_fused_sharded)

    # the split whose largest block and halo ring stream the fewest bytes
    # (parallel/mesh.factor_devices_for_grid); one process: the whole grid
    mesh = grid_mesh(grid_shape=(ny, nx), device=dev)
    n = mesh.shape[0] * mesh.shape[1] * mesh.shape[2]

    def cut(a):
        return distributed.local_shard_array(a, mesh)

    sh = derived_fields_fused_sharded(
        mesh, *(from_sentinel(cut(a), device=dev)
                for a in (tk, q, u, v, ps)),
        *(cut(a) for a in (alevel, blevel, mapr, mapr, fcor)))
    vort = distributed.gather(sh.vort, mesh)
    m = out.vort.mask
    res["sharded_devices"] = n
    res["sharded_agree"] = bool(torch.allclose(
        vort.values[m], out.vort.values[m], rtol=2e-5))
    say(f"sharded over {n} device(s) [{mesh.shape}] — matches single-"
        f"device vorticity: {res['sharded_agree']}")

    # -- 4. batch boundaries: one call per product FAMILY -----------------
    # any set of hybrid-level conversions in ONE kernel pass (sentinel
    # numpy in/out; fully defined steps take the all-defined route)
    from mi_fieldcalc_tpu_torch.staging import run_hlevel_suite_np

    suite = run_hlevel_suite_np(tk, q, None, ps, alevel, blevel,
                                temps=(3,), hums_q=(1, 9), device=dev)
    td = suite["hum_q9"]
    res["suite_td_mean"] = float(td[td < 1e34].mean())
    res["suite_keys"] = sorted(suite)
    say(f"suite dewpoint (K): mean {res['suite_td_mean']:6.1f} "
        f"({res['suite_keys']})")

    # -- 5. call storms: many small drop-in calls, ONE device program ------
    # the Diana-caller pattern: on CUDA one graph per storm signature
    t850 = np.asarray(tk[-1])
    rh850 = np.clip(np.abs(np.asarray(q[-1])) * 1e4, 5.0, 95.0)
    with fc.batch(device=dev):
        tc = fc.cvtemp(t850, 1, device=dev)          # K -> C, deferred
        hum = fc.plevelhum(t850, rh850, 850.0, "", 3, device=dev)
        back = fc.cvtemp(tc, 2, device=dev)          # C -> K on the device
    hv = np.asarray(hum)
    res["storm_roundtrip"] = float(np.abs(np.asarray(back) - t850).max())
    res["storm_q850_mean"] = float(hv[hv < 1e34].mean())
    say(f"storm of 3 ran as one program: cvtemp roundtrip max|d| = "
        f"{res['storm_roundtrip']:.2g}, "
        f"q850 mean {res['storm_q850_mean']:.2e} kg/kg")

    # -- 6. forecast cycles: device-resident inputs across storms ----------
    # cache_inputs=True keeps concrete inputs on the device (identity-
    # keyed); a repeated cycle ships only the arrays that changed
    res["cycle_q850_mean"] = []
    for cycle in range(2):
        t_new = t850 + np.float32(0.1 * cycle)   # "changed" field
        with fc.batch(cache_inputs=True, device=dev):
            fc.cvtemp(t_new, 2, device=dev)      # t_new ships; rh850
            h = fc.plevelhum(t_new, rh850, 850.0, "", 3,
                             device=dev)         # rides the cache
        hm = np.asarray(h)
        res["cycle_q850_mean"].append(float(hm[hm < 1e34].mean()))
        say(f"cycle {cycle}: q850 mean "
            f"{res['cycle_q850_mean'][-1]:.2e} kg/kg")

    # -- 7. subset consumers: fetch only the planes you read --------------
    with fc.batch(cache_inputs=True, device=dev):
        c1 = fc.cvtemp(t850, 1, device=dev)        # K -> C
        h1 = fc.plevelhum(t850, rh850, 850.0, "", 3, device=dev)
        fc.cvtemp(rh850, 2, device=dev)            # computed, never fetched
    cv, hv1 = fc.fetch(c1, h1)                     # one transfer, 2 planes
    res["subset_tc_mean"] = float(cv[cv < 1e34].mean())
    res["subset_q850_mean"] = float(hv1[hv1 < 1e34].mean())
    say(f"subset fetch: tc mean {res['subset_tc_mean']:6.1f} C, "
        f"q850 mean {res['subset_q850_mean']:.2e} kg/kg")

    # -- 8. aligned ingest: the production-grid option --------------------
    # a ragged producer grid re-gridded once at ingest onto the aligned
    # product grid (mask-aware bilinear, map ratios rescaled); the product
    # grid changes (e.g. 719x929 -> 720x1024)
    from mi_fieldcalc_tpu_torch.staging import run_derived_fields_np
    rag = np.s_[..., :95, :121]                 # a ragged producer grid
    out_al = run_derived_fields_np(tk[rag], q[rag], u[rag], v[rag], ps[rag],
                                   alevel, blevel, mapr[rag], mapr[rag],
                                   fcor[rag], align=True, device=dev)
    th = out_al["th"]
    res["aligned_grid"] = list(th.shape[-2:])
    res["aligned_th_mean"] = float(th[th < 1e34].mean())
    res["aligned_thetae_undef"] = int((out_al["thetae"] >= 1e34).sum())
    say(f"aligned ingest: product grid {th.shape[-2:]} "
        f"(from {tk[rag].shape[-2:]})")
    return res


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    main(ap.parse_args().device)
