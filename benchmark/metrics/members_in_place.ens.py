"""Members a summary whose pipeline-kernel launch wrote its planes in
place in the member stack (the program's counter
``ensemble.members_in_place``); nothing where the program counts none, as
on the CPU and in a program that copies every member into the stack."""

from benchmark.metrics._program import counter


def read(run):
    n = counter("ensemble.members_in_place")
    return None if n is None else n / run.units
