#!/usr/bin/env bash
# Sandbox case (the counterpart of tests/cases/sandbox.sh):
# sandboxWorkloads.enabled=true with vm-passthrough nodes.
set -euo pipefail
export CHART_EXTRA_ARGS="--set sandboxWorkloads.enabled=true"
exec "$(dirname "$0")/../scripts/end-to-end.sh"
