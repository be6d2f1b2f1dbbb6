#!/usr/bin/env bash
# Default case (the counterpart of tests/cases/defaults.sh): stock values
# end-to-end.
set -euo pipefail
exec "$(dirname "$0")/../scripts/end-to-end.sh"
