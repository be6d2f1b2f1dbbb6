"""K3 launches a pass: the program's exact count (``_build.launches["flash_fwd"]``)
over the window's passes."""

COUNTER = "flash_fwd"


def read(run):
    launches = run.counters.get("launches", {}).get(COUNTER, 0)
    return launches / run.counters["passes"] if launches else None
