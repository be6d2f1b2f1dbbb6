#!/usr/bin/env bash
# E2E sequence of the H100 port on a real cluster with NVIDIA H100 nodes
# (the counterpart of tests/scripts/end-to-end.sh, its steps in the same
# order): install -> verify -> workload -> update -> disable/enable
# operands -> uninstall.
set -euo pipefail
HERE=$(dirname "$0")
source "$HERE/checks.sh"

: "${CHART:=$HERE/../../deploy/gpu-operator}"
: "${TEST_NAMESPACE:=tpu-operator}"
POD_YAML=$HERE/../../deploy/gpu-pod.yaml
# the port's names: the operator's app and Deployment, and the operand
# apps of consts.OPERAND_APPS (the DaemonSets carry the same names)
OPERATOR_APP=gpu-operator
VALIDATOR_APP=gpu-operator-validator
PLUGIN_APP=gpu-device-plugin-daemonset
EXPORTER_APP=gpu-metrics-exporter
WORKLOAD_POD=torch-matmul

echo "=== install-operator"
# shellcheck disable=SC2086  # CHART_EXTRA_ARGS is intentionally word-split
helm upgrade --install gpu-operator "$CHART" \
  --namespace "$TEST_NAMESPACE" --create-namespace --wait \
  ${CHART_EXTRA_ARGS:-}

echo "=== verify-operator"
check_pod_ready "$OPERATOR_APP"
check_clusterpolicy_ready
check_pod_ready "$VALIDATOR_APP"

echo "=== verify-operand-restarts (operator restart must not roll operands)"
before=$(kubectl -n "$TEST_NAMESPACE" get pods -l "app=$PLUGIN_APP" -o jsonpath='{.items[*].metadata.uid}')
kubectl -n "$TEST_NAMESPACE" rollout restart "deployment/$OPERATOR_APP"
kubectl -n "$TEST_NAMESPACE" rollout status "deployment/$OPERATOR_APP" --timeout=5m
check_clusterpolicy_ready
after=$(kubectl -n "$TEST_NAMESPACE" get pods -l "app=$PLUGIN_APP" -o jsonpath='{.items[*].metadata.uid}')
[ "$before" = "$after" ] || { echo "operands restarted on operator restart" >&2; exit 1; }

echo "=== install-workload"
kubectl apply -f "$POD_YAML"
check_pod_succeeded "$WORKLOAD_POD"
kubectl logs "$WORKLOAD_POD" | grep OK
kubectl delete -f "$POD_YAML"

echo "=== update-clusterpolicy"
kubectl patch clusterpolicies.tpu.k8s.io cluster-policy --type merge \
  -p '{"spec":{"metricsExporter":{"enabled":false}}}'
sleep 15
kubectl -n "$TEST_NAMESPACE" get ds "$EXPORTER_APP" 2>/dev/null && \
  { echo "exporter not deleted after disable" >&2; exit 1; }

echo "=== enable-operands"
kubectl patch clusterpolicies.tpu.k8s.io cluster-policy --type merge \
  -p '{"spec":{"metricsExporter":{"enabled":true}}}'
check_clusterpolicy_ready

echo "=== deep-diagnostics (opt-in ringattn probe rolls the validator)"
kubectl patch clusterpolicies.tpu.k8s.io cluster-policy --type merge \
  -p '{"spec":{"validator":{"ringattn":{"enabled":true}}}}'
sleep 15
check_clusterpolicy_ready
kubectl -n "$TEST_NAMESPACE" get ds "$VALIDATOR_APP" \
  -o jsonpath='{.spec.template.spec.initContainers[*].name}' | \
  grep -q ringattn-validation || \
  { echo "ringattn initContainer missing after enable" >&2; exit 1; }
kubectl patch clusterpolicies.tpu.k8s.io cluster-policy --type merge \
  -p '{"spec":{"validator":{"ringattn":null}}}'
check_clusterpolicy_ready

echo "=== uninstall"
helm uninstall gpu-operator --namespace "$TEST_NAMESPACE"
echo "E2E PASSED"
