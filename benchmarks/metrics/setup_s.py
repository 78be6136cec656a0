"""Seconds from the start of the process to the first timed unit: imports,
the kernels' load (their build, in a checkout's first run), the weights,
the capture and the warm-up."""


def read(run):
    return run.setup_s
