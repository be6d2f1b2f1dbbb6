"""Seconds from the run's first line to the first timed pass: the imports,
the CUDA context, the kernel library (built on a checkout's first run),
the cell's components and one warm pass."""


def read(run):
    return run.setup_s
