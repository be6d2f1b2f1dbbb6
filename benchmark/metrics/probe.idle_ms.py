"""Milliseconds a pass in which the card idles under a ``probe.*`` span of
the program and no deeper one (``progtrace``): a probe's inputs, its build,
its check and integrity, and its chains outside their timed rounds."""

from benchmark import progtrace

LAYER = "probe"


def read(run):
    return progtrace.idle_ms_a_pass(run, LAYER)
