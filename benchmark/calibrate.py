"""The readings that the limits of ``correct`` are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1-12 --control-seeds 1-3

For each seed, the numbers each of the cell's components compares (its
kernels on inputs from the seed, against the plain reference), and for
each control seed the same numbers with the reference one precision lower
in the program's place. One JSON line a reading on standard output; the
largest sound reading and the smallest control reading of each number
last. The entry's own call is held on every seed too (``harness.hold``);
its inputs are the probes' own, so the seed does not reach those numbers.
Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(run, seed_list, control: bool) -> list:
    from benchmark import harness

    rows = []
    for seed in seed_list:
        found = harness.check(run, seed, control=control)
        row = {k: v for k, (v, _) in found.items() if v is not None}
        rows.append(row)
        print(json.dumps({"seed": seed, "control": control, **row}), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="1-3")
    args = p.parse_args(argv)
    from benchmark import harness

    import tempfile

    with tempfile.TemporaryDirectory(prefix="bench-status-") as status:
        run = harness.setup(harness.Bench(ROOT), args.workload, "cuda", status, False)
        sound = readings(run, seeds(args.seeds), control=False)
        ctrl = readings(run, seeds(args.control_seeds), control=True)
    summary = {}
    for key in sound[0]:
        summary[key] = {"lower": max(r[key] for r in sound),
                        "upper": min(r[key] for r in ctrl if key in r) if ctrl else None}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
