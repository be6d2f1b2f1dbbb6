#!/usr/bin/env bash
# Polling helpers of the H100 port's cluster e2e (the counterpart of
# tests/scripts/checks.sh, with its timeouts and messages). The namespace
# and the CRD group are the reference's own (consts.DEFAULT_NAMESPACE,
# consts.GROUP).

: "${TEST_NAMESPACE:=tpu-operator}"
: "${POLL_S:=10}"
: "${TIMEOUT_S:=2700}"   # 45min ceiling, same as the reference

check_pod_ready() {
  local label=$1 deadline=$((SECONDS + TIMEOUT_S)) statuses pods n_pods n_ready
  while [ $SECONDS -lt $deadline ]; do
    pods=$(kubectl -n "$TEST_NAMESPACE" get pods -l "app=$label" \
        -o jsonpath='{.items[*].metadata.name}')
    statuses=$(kubectl -n "$TEST_NAMESPACE" get pods -l "app=$label" \
        -o jsonpath='{.items[*].status.conditions[?(@.type=="Ready")].status}')
    # every pod must report Ready=True; pods with no Ready condition yet
    # (just scheduled) produce fewer statuses than pods, so compare counts
    n_pods=$(echo "$pods" | wc -w)
    n_ready=$(echo "$statuses" | tr ' ' '\n' | grep -c '^True$' || true)
    if [ "$n_pods" -gt 0 ] && [ "$n_ready" -eq "$n_pods" ]; then
      echo "pods for $label Ready ($n_ready/$n_pods)"
      return 0
    fi
    echo "waiting for $label pods ($n_ready/$n_pods ready)..."
    sleep "$POLL_S"
  done
  echo "TIMEOUT waiting for $label" >&2
  return 1
}

check_clusterpolicy_ready() {
  local deadline=$((SECONDS + TIMEOUT_S))
  while [ $SECONDS -lt $deadline ]; do
    state=$(kubectl get clusterpolicies.tpu.k8s.io -o jsonpath='{.items[0].status.state}')
    [ "$state" = ready ] && { echo "ClusterPolicy ready"; return 0; }
    echo "ClusterPolicy state=$state; waiting..."
    sleep "$POLL_S"
  done
  echo "TIMEOUT waiting for ClusterPolicy ready" >&2
  return 1
}

check_pod_succeeded() {
  local name=$1 deadline=$((SECONDS + 300))   # 5min, reference 60x5s
  while [ $SECONDS -lt $deadline ]; do
    phase=$(kubectl get pod "$name" -o jsonpath='{.status.phase}' 2>/dev/null)
    [ "$phase" = Succeeded ] && { echo "$name Succeeded"; return 0; }
    [ "$phase" = Failed ] && { echo "$name Failed" >&2; return 1; }
    sleep 5
  done
  echo "TIMEOUT waiting for $name" >&2
  return 1
}
