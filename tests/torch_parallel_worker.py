"""One gloo rank of the sharded test cases (``tests/torch_parallel_cases.py``).

    python tests/torch_parallel_worker.py GROUP RANK WORLD PORT OUT

joins a gloo process group of WORLD ranks at ``127.0.0.1:PORT``, runs
every case of ``CASES[GROUP]`` in order on its own blocks (each case's
grid built once per shape, on every rank in the same order), and rank 0
saves the cases' results to OUT with ``torch.save``.  Imports torch and
the port, never jax.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import torch  # noqa: E402

torch.set_num_threads(1)

from mi_fieldcalc_tpu_torch.parallel import distributed, grid_mesh  # noqa
import torch_parallel_cases  # noqa: E402


def main(group: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    grids, results = {}, {}
    for name, case in torch_parallel_cases.CASES[group]().items():
        if case.mesh not in grids:
            grids[case.mesh] = grid_mesh(case.mesh, device="cpu")
        results[name] = case.sharded(grids[case.mesh])
    if rank == 0:
        torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    g, r, w, p, o = sys.argv[1:6]
    main(g, int(r), int(w), int(p), o)
