"""Milliseconds a pass in the flash probe's check (the program's
``probe.flash.check`` spans, summed): K3 once, the f32 oracle over the whole
score matrix, and the ``max_err`` fetch, which waits for the card."""

from benchmark import progtrace

SPAN = "probe.flash.check"


def read(run):
    return progtrace.span_ms_a_pass(run, SPAN)
