"""Seconds from process start to the end of the warm-up: imports, the kernels'
build, the first steps and every shape the window uses."""


def read(run):
    return run.setup_s
