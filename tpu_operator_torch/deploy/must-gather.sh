#!/usr/bin/env bash
# Support-bundle collector for the GPU operator: runs as a must-gather
# plugin image at /usr/bin/gather or standalone via kubectl.
#
# Collects: cluster + ClusterPolicy state, GPU node facts (labels,
# capacity, OS/kubelet info), NFD features, slice/NVLink-domain status,
# per-node /run/tpu/validations host status files (through the
# gpu-node-status-exporter pods, which mount them), operand pod logs
# including previous containers, DaemonSet descriptions, Events and
# PrometheusRules, then packages everything into a tarball.
#
#   KUBECTL=kubectl OPERATOR_NAMESPACE=tpu-operator VERSION=0.2.0 \
#     bash tpu_operator_torch/deploy/must-gather.sh
#
# ARTIFACT_DIR names the output directory (default
# /tmp/gpu-operator-must-gather_<date>); the tarball is written beside it.
set -o pipefail

K=${KUBECTL:-kubectl}
if ! $K version > /dev/null 2>&1; then
  echo "FATAL: '$K' is not working; set KUBECTL to a working client" >&2
  exit 1
fi

if [[ "$0" == "/usr/bin/gather" ]]; then
  # running as a must-gather plugin image
  OUT=/must-gather
else
  OUT=${ARTIFACT_DIR:-/tmp/gpu-operator-must-gather_$(date +%Y%m%d_%H%M%S)}
fi
NS=${OPERATOR_NAMESPACE:-tpu-operator}
mkdir -p "$OUT"

# tee everything we print; stderr separately; keep the original fds on
# 3/4 so packaging results stay visible on the terminal after the logs
# are closed for archiving
exec 3>&1 4>&2
exec 1> >(tee "$OUT/must-gather.log")
TEE_PID=$!  # plain `wait` skips process substitutions on bash < 5.1
exec 2> "$OUT/must-gather.stderr.log"

echo "collecting into $OUT (namespace $NS)"
{ echo "GPU Operator"; echo "${VERSION:-N/A}"; } > "$OUT/version"

echo "# cluster"
mkdir -p "$OUT/cluster"
$K version -o yaml > "$OUT/cluster/version.yaml"
$K get clusterpolicies.tpu.k8s.io -o yaml > "$OUT/cluster/clusterpolicy.yaml"
if ! $K get clusterpolicies.tpu.k8s.io -o name | grep -q .; then
  touch "$OUT/cluster/clusterpolicy.missing"
fi
$K get crd clusterpolicies.tpu.k8s.io -o yaml > "$OUT/cluster/crd.yaml"
$K get events -A --sort-by=.lastTimestamp > "$OUT/cluster/events.txt"

echo "# nodes"
mkdir -p "$OUT/nodes"
$K get nodes -o yaml > "$OUT/nodes/nodes.yaml"
$K get nodes -o wide > "$OUT/nodes/nodes.txt"
$K describe nodes -l tpu.k8s.io/tpu.present=true > "$OUT/nodes/gpu-nodes.descr"
# one line per node: the whole label bus (deploy labels, slice FSM,
# upgrade FSM, card variant)
$K get nodes -o custom-columns='NAME:.metadata.name,GPU:.metadata.labels.tpu\.k8s\.io/tpu\.present,GEN:.metadata.labels.tpu\.k8s\.io/tpu\.generation,SLICEID:.metadata.labels.tpu\.k8s\.io/tpu\.slice-id,SLICEREADY:.metadata.labels.tpu\.k8s\.io/tpu\.slice\.ready,SLICECFG:.metadata.labels.tpu\.k8s\.io/tpu\.slice\.config\.state,UPGRADE:.metadata.labels.tpu\.k8s\.io/driver-upgrade-state' \
  > "$OUT/nodes/node-labels.txt"
# OS / kubelet / runtime facts
$K get nodes -o custom-columns='NAME:.metadata.name,OS:.status.nodeInfo.osImage,KERNEL:.status.nodeInfo.kernelVersion,KUBELET:.status.nodeInfo.kubeletVersion,RUNTIME:.status.nodeInfo.containerRuntimeVersion,ARCH:.status.nodeInfo.architecture' \
  > "$OUT/nodes/node-os-info.txt"
$K get nodes -o custom-columns='NAME:.metadata.name,GPUCAP:.status.capacity.nvidia\.com/gpu,GPUALLOC:.status.allocatable.nvidia\.com/gpu' \
  > "$OUT/nodes/gpu-capacity.txt"

echo "# NFD features"
mkdir -p "$OUT/nfd"
$K get nodefeatures -A -o yaml > "$OUT/nfd/nodefeatures.yaml" 2>/dev/null \
  || echo "nodefeatures API not present" > "$OUT/nfd/nodefeatures.yaml"
$K get nodefeaturerules -o yaml > "$OUT/nfd/nodefeaturerules.yaml" 2>/dev/null \
  || echo "nodefeaturerules API not present" > "$OUT/nfd/nodefeaturerules.yaml"

echo "# slice / NVLink domains"
mkdir -p "$OUT/slices"
$K get clusterpolicies.tpu.k8s.io -o jsonpath='{.items[0].status.slices}' \
  > "$OUT/slices/slice-status.json"
$K -n "$NS" get configmaps -l app=gpu-slice-manager -o yaml \
  > "$OUT/slices/slice-configmaps.yaml"

echo "# operator + operands"
mkdir -p "$OUT/operator" "$OUT/pod-logs"
$K -n "$NS" get all -o wide > "$OUT/operator/workloads.txt"
$K -n "$NS" get daemonsets -o yaml > "$OUT/operator/daemonsets.yaml"
for ds in $($K -n "$NS" get daemonsets -o name); do
  name=${ds#daemonset.apps/}
  $K -n "$NS" describe "$ds" > "$OUT/operator/ds-$name.descr"
done
$K -n "$NS" get configmaps -o yaml > "$OUT/operator/configmaps.yaml"
$K -n "$NS" get events --sort-by=.lastTimestamp > "$OUT/operator/events.txt"
$K -n "$NS" get prometheusrules -o yaml > "$OUT/operator/prometheus-rules.yaml" 2>/dev/null \
  || echo "prometheusrules API not present" > "$OUT/operator/prometheus-rules.yaml"
# image inventory: pod -> all containers' images incl. initContainers
# (supports image-mismatch triage)
$K -n "$NS" get pods \
  -o jsonpath='{range .items[*]}{.metadata.name}{": "}{range .spec.initContainers[*]}{.image}{" "}{end}{range .spec.containers[*]}{.image}{" "}{end}{"\n"}{end}' \
  > "$OUT/operator/pod-images.txt"

for pod in $($K -n "$NS" get pods -o name); do
  name=${pod#pod/}
  $K -n "$NS" logs --all-containers --prefix --tail=2000 "$name" \
    > "$OUT/pod-logs/$name.log" 2>&1
  # previous incarnations per container, initContainers too (an
  # Init:CrashLoopBackOff driver installer is a primary use case): the
  # crash being debugged usually lives here, and --all-containers
  # --previous would fail for the WHOLE pod when any sibling container
  # never restarted
  for ctr in $($K -n "$NS" get "$pod" -o jsonpath='{.spec.initContainers[*].name} {.spec.containers[*].name}'); do
    $K -n "$NS" logs -c "$ctr" --previous --tail=2000 "$name" \
      > "$OUT/pod-logs/$name.$ctr.previous.log" 2>&1 \
      || rm -f "$OUT/pod-logs/$name.$ctr.previous.log"
  done
  $K -n "$NS" describe "$pod" > "$OUT/pod-logs/$name.descr" 2>&1
done

echo "# per-node /run/tpu/validations (host status files)"
# the node-status-exporter DaemonSet mounts /run/tpu on every GPU node:
# exec through it to read the barrier files the validator wrote
mkdir -p "$OUT/validations"
for pod in $($K -n "$NS" get pods -l app=gpu-node-status-exporter -o name); do
  name=${pod#pod/}
  node=$($K -n "$NS" get "$pod" -o jsonpath='{.spec.nodeName}')
  [ -z "$node" ] && node=$name
  {
    echo "## $node ($name)"
    $K -n "$NS" exec "$name" -- sh -c \
      'ls -l /run/tpu/validations 2>/dev/null; for f in /run/tpu/validations/*; do [ -f "$f" ] && echo "--- $f" && cat "$f"; done; exit 0' \
      || echo "(exec failed; node state unavailable)"
  } > "$OUT/validations/$node.txt" 2>&1
done

# close the bundle logs (and let tee drain) BEFORE archiving, or tar can
# see must-gather.log grow mid-read and fail; report on the terminal fds
exec 1>&3 2>&4
wait "$TEE_PID" 2>/dev/null || true
TARBALL="$OUT.tar.gz"
if tar -czf "$TARBALL" -C "$(dirname "$OUT")" "$(basename "$OUT")"; then
  echo "done: $OUT (tarball $TARBALL)"
else
  echo "ERROR: tarball packaging failed; raw bundle left at $OUT" >&2
  exit 1
fi
