"""The share of the interpolation kernel's columns that took its binary
search (the program's counter ``b2.searched_columns`` over its
``b2.columns``), %; nothing where the program counts neither, as on the
CPU and in a program whose kernel does not count its routes."""

from benchmark.metrics._program import counter


def read(run):
    searched = counter("b2.searched_columns")
    columns = counter("b2.columns")
    if searched is None or not columns:
        return None
    return 100.0 * searched / columns
