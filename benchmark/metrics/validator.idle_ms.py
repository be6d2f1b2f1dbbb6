"""Milliseconds a pass in which the card idles under a ``validator.*`` span
of the program and no deeper one (``progtrace``): the component around its
probe, its utilisation gate, its payload and its status file."""

from benchmark import progtrace

LAYER = "validator"


def read(run):
    return progtrace.idle_ms_a_pass(run, LAYER)
