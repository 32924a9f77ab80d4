"""The small sizes at which the CPU tests run a cell: the ``cpu_test`` of the
cell's configuration file, the configuration's keys to override and their
small values.  No run on the card reads ``cpu_test``."""

from benchmark import harness


def small(spec: dict, cell: str) -> dict:
    config = harness.resolve(spec, cell)["config"]
    name = {w["name"]: w["config"] for w in spec["workloads"]}[cell]
    file = {c["name"]: c["file"] for c in spec["configs"]}[name]
    if "cpu_test" not in config:
        raise LookupError(f"{file} has no key 'cpu_test' (the keys the CPU "
                          f"tests override and their small values)")
    unknown = sorted(set(config["cpu_test"]) - set(config))
    if unknown:
        raise LookupError(f"{file}: 'cpu_test' overrides {unknown}, which "
                          f"the configuration does not have")
    return config["cpu_test"]


SPEC = harness.benchmark_spec()
