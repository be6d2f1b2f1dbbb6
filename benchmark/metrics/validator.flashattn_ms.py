"""Mean host milliseconds of the benchmark's span around each
``validate_flashattn`` call in the window (the probe ends in a synchronise)."""

SPAN = "flashattn"


def read(run):
    spans = [e - s for name, s, e in run.spans if name == SPAN]
    return 1e3 * sum(spans) / len(spans) if spans else None
