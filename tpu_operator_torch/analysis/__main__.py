"""CLI: ``python -m tpu_operator_torch.analysis`` — the port's lint gate,
the counterpart of the reference's ``make lint`` engine.

Exit status: 0 when every finding is baselined or suppressed, 1 when
any NEW finding exists (the gate bites), 2 on usage/config errors.
Output is deterministic (two runs on the same tree are byte-identical).
"""

from __future__ import annotations

import argparse
import os
import sys

from tpu_operator_torch.analysis.config import load_config
from tpu_operator_torch.analysis.engine import run_analysis, write_baseline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_operator_torch.analysis",
        description="Project-native concurrency & contract analyzer "
        "(rule catalog: the reference's docs/analysis.md)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to scan (default: [tool.gpu_analysis] paths)",
    )
    parser.add_argument(
        "--repo-root", default=".", help="repository root (pyproject.toml location)"
    )
    parser.add_argument("--baseline", help="baseline file (default from config)")
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring the baseline",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept the current findings as the new baseline",
    )
    parser.add_argument(
        "--disable", action="append", default=[], metavar="RULE",
        help="disable a rule id (repeatable)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text"
    )
    args = parser.parse_args(argv)

    try:
        config = load_config(args.repo_root)
    except ValueError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    config.disable = sorted(set(config.disable) | set(args.disable))

    try:
        report = run_analysis(
            config,
            paths=args.paths or None,
            baseline_path=args.baseline,
            use_baseline=not (args.no_baseline or args.write_baseline),
        )
    except ValueError as e:
        print(f"analysis error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        path = args.baseline or os.path.join(config.repo_root, config.baseline)
        write_baseline(path, report.findings)
        print(f"baseline written: {path} ({len(report.findings)} finding(s))")
        return 0

    print(
        report.render_text() if args.format == "text" else report.render_json()
    )
    return 1 if report.new else 0


if __name__ == "__main__":
    sys.exit(main())
