"""Run one cell of the benchmark on the card and print its result's line.

    python3 benchmark/run.py --workload arome_l65.ens10 --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``check``: each
number compared with its limit); the same numbers are the last lines of
standard error.  Exits non-zero and prints no result without a CUDA card
for every chip the cell asks for, or if the run loaded ``jax``, ``jaxlib``,
``flax`` or the JAX package.  A cell on one chip runs in this process; a
cell on N > 1 runs as N processes, one a card, started and reported as one
run by :func:`benchmark.ranks.launch` (exit 1 and no result where a rank
fails or stalls).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.benchmark_spec()
    cell = harness.resolve(spec, args.workload)["cell"]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if chips == 1:
        out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START)
        bad = harness.forbidden_modules()
    else:
        from benchmark import ranks
        job = {"mode": "run", "cell": args.workload, "seed": args.seed,
               "seconds": args.seconds, "trace": args.trace,
               "t_start": time.monotonic() - (time.perf_counter() - T_START)}
        code, out, bad = ranks.launch(job, chips, "cuda")
        if code:
            return code
        bad = sorted(set(bad) | set(harness.forbidden_modules()))
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
