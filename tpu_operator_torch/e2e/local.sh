#!/usr/bin/env bash
# Test launcher of the H100 port (the counterpart of tests/local.sh):
#
#   tpu_operator_torch/e2e/local.sh fake       # no cluster needed: in-memory e2e
#   tpu_operator_torch/e2e/local.sh defaults   # full e2e on the current kube context
#   tpu_operator_torch/e2e/local.sh sandbox    # e2e with sandboxWorkloads enabled
#
# For real cases the kube context must point at a cluster with an NVIDIA
# H100 node pool (e.g. tpu_operator_torch/e2e/gke/cluster-up.sh) and the
# port's images pushed (make -f tpu_operator_torch/deploy/Makefile
# docker-push).
set -euo pipefail
HERE=$(cd "$(dirname "$0")" && pwd)
CASE=${1:-fake}

case "$CASE" in
  fake)
    exec python3 -m tpu_operator_torch.e2e.fake_e2e
    ;;
  defaults|sandbox)
    command -v kubectl >/dev/null || { echo "kubectl required" >&2; exit 1; }
    command -v helm >/dev/null || { echo "helm required" >&2; exit 1; }
    exec "$HERE/cases/$CASE.sh"
    ;;
  *)
    echo "unknown case: $CASE (want fake|defaults|sandbox)" >&2
    exit 2
    ;;
esac
