"""The window's wall seconds over the passes (or gate readings) it completed."""


def read(run):
    return run.window_s / len(run.durations) if run.durations else None
