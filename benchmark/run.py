"""One run of one benchmark cell on the CUDA card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks beside their limits on standard error and one JSON
line on standard output (``harness.run_cell``). Exits non-zero and prints
no result without enough CUDA cards, when a metric the cell reports reads
nothing, when a rank of a cell's world fails, or when a module of JAX or of
the JAX package is loaded once the window has closed, in this process or in
a helper rank.
"""

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed pass

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="draws the checked inputs")
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    from benchmark import harness

    bench = harness.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda", t0=T0)
    except harness.SilentMetric as e:
        print(f"run: {e}", file=sys.stderr)
        return 4
    except harness.WorldError as e:
        print(f"run: {e}", file=sys.stderr)
        return 5
    except harness.ForbiddenModules as e:
        print(f"run: loaded modules a run may not load: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"run: loaded modules a run may not load: {', '.join(found)}", file=sys.stderr)
        return 3
    print(harness.card_line(), file=sys.stderr)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
