"""Small sizes at which the CPU tests run the cells."""

from benchmark import harness

SMALL = {"arome_l65": {"members": 3, "levels": 3, "ny": 17, "nx": 23}}


def small(spec: dict, cell: str) -> dict:
    config = {w["name"]: w["config"] for w in spec["workloads"]}[cell]
    return SMALL[config]


SPEC = harness.benchmark_spec()
