#!/usr/bin/env bash
# Deploy the H100 port's operator onto the current kube context (the
# counterpart of scripts/install-tpu-operator.sh: namespace -> registry
# secret -> helm install with environment-driven overrides).
#
# Usage:
#   ./tpu_operator_torch/deploy/scripts/install-gpu-operator.sh
#
# Environment:
#   OPERATOR_NAMESPACE   target namespace            (default tpu-operator)
#   REGISTRY             image registry              (default gcr.io/tpu-operator)
#   VERSION              operator image version      (default chart appVersion)
#   REGISTRY_SECRET      optional imagePullSecret name to create from
#                        REGISTRY_JSON_KEY (a docker-registry JSON key file)
#   DRIVER_VERSION       optional driver installer version override
#   EXTRA_HELM_ARGS      appended verbatim to helm install
set -euo pipefail

HERE=$(cd "$(dirname "$0")/.." && pwd)
CHART="$HERE/gpu-operator"

OPERATOR_NAMESPACE=${OPERATOR_NAMESPACE:-tpu-operator}
REGISTRY=${REGISTRY:-gcr.io/tpu-operator}

command -v kubectl >/dev/null || { echo "kubectl required" >&2; exit 1; }
command -v helm >/dev/null || { echo "helm required" >&2; exit 1; }

# step 1: namespace
kubectl get namespace "$OPERATOR_NAMESPACE" >/dev/null 2>&1 ||
  kubectl create namespace "$OPERATOR_NAMESPACE"

# every chart section that owns an image (operator Deployment + operands);
# a registry/pull-secret override must reach all of them or operand pods
# ImagePullBackOff against the default registry
IMAGE_SECTIONS=(
  operatorDeployment driver toolkit devicePlugin metricsd metricsExporter
  nodeStatusExporter tfd sliceManager validator vfioManager
  sandboxDevicePlugin vmManager vmDeviceManager kataManager
)

# step 2: optional private-registry pull secret
SECRET_ARGS=()
if [[ -n "${REGISTRY_SECRET:-}" ]]; then
  : "${REGISTRY_JSON_KEY:?REGISTRY_SECRET set but REGISTRY_JSON_KEY (key file) missing}"
  kubectl -n "$OPERATOR_NAMESPACE" create secret docker-registry \
    "$REGISTRY_SECRET" \
    --docker-server="${REGISTRY%%/*}" \
    --docker-username=_json_key \
    --docker-password="$(cat "$REGISTRY_JSON_KEY")" \
    --dry-run=client -o yaml | kubectl apply -f -
  # the Deployment takes k8s-shaped {name: ...}; ClusterPolicy operand
  # specs take plain secret-name strings
  SECRET_ARGS+=(--set "operatorDeployment.imagePullSecrets[0].name=$REGISTRY_SECRET")
  for section in "${IMAGE_SECTIONS[@]:1}"; do
    SECRET_ARGS+=(--set "$section.imagePullSecrets[0]=$REGISTRY_SECRET")
  done
fi

# step 3: helm install/upgrade
REGISTRY_ARGS=()
for section in "${IMAGE_SECTIONS[@]}"; do
  REGISTRY_ARGS+=(--set "$section.repository=$REGISTRY")
done
VERSION_ARGS=()
[[ -n "${VERSION:-}" ]] && VERSION_ARGS+=(--set "operatorDeployment.version=$VERSION")
[[ -n "${DRIVER_VERSION:-}" ]] && VERSION_ARGS+=(--set "driver.version=$DRIVER_VERSION")

# empty-array expansion guarded for bash < 4.4 under `set -u`
# shellcheck disable=SC2086
helm upgrade --install gpu-operator "$CHART" \
  --namespace "$OPERATOR_NAMESPACE" \
  "${REGISTRY_ARGS[@]}" \
  ${SECRET_ARGS[@]+"${SECRET_ARGS[@]}"} ${VERSION_ARGS[@]+"${VERSION_ARGS[@]}"} \
  --wait ${EXTRA_HELM_ARGS:-}

echo "gpu-operator deployed to namespace $OPERATOR_NAMESPACE"
kubectl -n "$OPERATOR_NAMESPACE" get clusterpolicy,daemonsets 2>/dev/null || true
