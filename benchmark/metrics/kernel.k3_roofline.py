"""K3's share of its roofline: the least time of its shape (the causal
triangle's FLOPs over the bf16 peak, or q, k, v and o once over the memory
bandwidth, the larger) over its mean device time a launch in the trace."""

import re

from benchmark.work import counts

# K3 as the library exports it: flash_fwd_wgmma_kernel<Step::kFull,
# Body::kOne, 2> (csrc/flash.cu, in an anonymous namespace), as the trace
# spells it, demangled ("((anonymous namespace)::Step)0") or mangled
_NS = r"(?:\(anonymous namespace\)::)?"
KERNEL = re.compile(
    r"flash_fwd_wgmma_kernel<\s*(?:\(" + _NS + r"Step\)0|" + _NS + r"Step::kFull)\s*,"
    r"\s*(?:\(" + _NS + r"Body\)0|" + _NS + r"Body::kOne)\s*,\s*2\s*>"
    r"|flash_fwd_wgmma_kernelIL(?:NS_)?4Step(?:E)?0EL(?:NS_)?4Body(?:E)?0ELi2E")


def read(run):
    shape = run.shapes.get("k3")
    if run.trace is None or shape is None or run.peak is None:
        return None
    mean = run.trace.mean_seconds(KERNEL)
    if mean is None:
        return None
    least = counts.least_seconds(counts.causal_attention_flops(**shape),
                                 counts.attention_bytes(**shape), run.peak)
    return 100.0 * least / mean
