"""K2's share of its roofline: the buffer read once and written once over
the memory bandwidth, over its mean device time a launch in the trace."""

import re

from benchmark.work import counts

# K2 as the library exports it: bulk_copy_kernel (csrc/copy.cu)
KERNEL = re.compile(r"bulk_copy_kernel")


def read(run):
    shape = run.shapes.get("k2")
    if run.trace is None or shape is None or run.peak is None:
        return None
    mean = run.trace.mean_seconds(KERNEL)
    if mean is None:
        return None
    least = counts.least_seconds(0.0, counts.copy_bytes(**shape), run.peak)
    return 100.0 * least / mean
