"""The 90th percentile (nearest rank) of the wall seconds of every pass in the window."""

import math


def read(run):
    if not run.durations:
        return None
    ranked = sorted(run.durations)
    return ranked[math.ceil(0.9 * len(ranked)) - 1]
