"""Device time a summary spends cropping each member's padded planes and
copying them into its slot of the member stack (the program's
``ensemble.member_stack`` spans inside the sharded summary), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "ensemble.member_stack")
