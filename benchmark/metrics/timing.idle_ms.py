"""Milliseconds a pass in which the card idles under a ``timing.round``
span of the program (``progtrace``): the synchronise and fetch that end each
timed round, the zero-length round, the launches a chain waits on."""

from benchmark import progtrace

LAYER = "timing"


def read(run):
    return progtrace.idle_ms_a_pass(run, LAYER)
