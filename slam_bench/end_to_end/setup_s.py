"""Seconds from the start of the process's benchmark code (before PyTorch
is imported) to the opening of the window: import, the matcher's build (a
cached library after the first run), the solver library's load, the world,
the path and the bank rendered on the card, the system, and the warm-up
drive."""


def read(run):
    return run.setup_s
