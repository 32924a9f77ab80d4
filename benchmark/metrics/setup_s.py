"""From the start of the process to the start of the window: imports,
the card's start, the build of the kernels where it is not cached, the
inputs drawn on the card and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
