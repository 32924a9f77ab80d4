"""The readings that each limit of the check is set from, on the card at a
cell's own size, in one process:

* the program's: a short window on each of ``--seeds`` (a dozen or more),
  then the check, as a run makes it;
* the control's: the plain reference put in the program's place with its
  output values rounded to bfloat16 and its masks exact (each entry's
  ``control()``), one unit of work for each lead time on each of
  ``--control-seeds``, then the same check.  It has to come out as not
  correct.

    python3 benchmark/readings.py --workload arome_l65.steps \\
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 1

One JSON line a seed; the benchmark's own runs do not run this.  A cell
on N > 1 chips runs as N ranks, one a card, as ``run.py`` runs it
(:func:`benchmark.ranks.launch`): each rank checks its own outputs, and a
line holds each number's largest value over the ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seeds, control_seeds, seconds: float,
             device="cuda", overrides: dict = None, group=None):
    """Yield ``{"seed", "kind", "check"}`` for every seed.  With ``group``
    (a rank of an N-card run, :class:`benchmark.ranks.Group`) rank 0
    yields the lines merged over the ranks, the other ranks nothing."""
    import torch
    from benchmark import harness
    from benchmark.spans import replaced

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    r = harness.resolve(harness.benchmark_spec(), cell)
    config = dict(r["config"], **(overrides or {}))
    traffic = r["traffic"]
    mod = harness.entry_module(traffic)
    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            entry = mod.Entry(config, traffic, seed, dev)
            if kind == "program":
                for i in range(int(traffic["warmup"])):
                    entry.step(i)
                entry.reset()
                units, _ = harness.window(entry, seconds,
                                          int(traffic["in_flight"]), dev,
                                          group)
            else:
                table = {target: (lambda _, fn=fn: fn)
                         for target, fn in entry.control().items()}
                with replaced(table):
                    units = entry.leads
                    for i in range(units):
                        entry.step(i)
            harness.synchronize(dev)
            check = entry.check()
            if group is not None:
                merged = group.merge({"units": units, "check": check})
                check = None if merged is None else merged["check"]
            del entry
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if check is not None:
                yield {"cell": cell, "seed": seed, "kind": kind,
                       "units": units,
                       "check": {k: v for k, (v, _) in check.items()},
                       "limits": {k: lim for k, (_, lim) in check.items()},
                       "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    chips = int(harness.resolve(harness.benchmark_spec(),
                                args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"readings.py: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    if chips == 1:
        for line in readings(args.workload, args.seeds, args.control_seeds,
                             args.seconds):
            print(json.dumps(line), flush=True)
        return 0
    from benchmark import ranks
    code, lines, _ = ranks.launch(
        {"mode": "readings", "cell": args.workload, "seeds": args.seeds,
         "control_seeds": args.control_seeds, "seconds": args.seconds},
        chips, "cuda")
    for line in lines or ():
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
