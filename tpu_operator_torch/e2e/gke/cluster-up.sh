#!/usr/bin/env bash
# Bring up a GKE cluster with an NVIDIA H100 node pool for the H100 port's
# real e2e runs (the counterpart of tests/gke/cluster-up.sh). GKE installs
# no driver on the pool (gpu-driver-version=disabled): the operator's
# driver state does.
#
# Usage:
#   GCP_PROJECT=my-proj ./tpu_operator_torch/e2e/gke/cluster-up.sh
#
# Environment (the reference's names; TPU_TOPOLOGY has no counterpart on
# a GPU pool, ACCELERATOR takes its place):
#   GCP_PROJECT     (required) GCP project id
#   CLUSTER_NAME    default gpu-operator-e2e
#   ZONE            default us-central1-a — pick a zone with H100 capacity
#   MACHINE_TYPE    default a3-highgpu-1g (one H100 80GB)
#   ACCELERATOR     default type=nvidia-h100-80gb,count=1,gpu-driver-version=disabled
#   NUM_NODES       default 1 (GPU hosts in the pool)
#   RELEASE_CHANNEL default rapid
set -euo pipefail

: "${GCP_PROJECT:?set GCP_PROJECT}"
CLUSTER_NAME=${CLUSTER_NAME:-gpu-operator-e2e}
ZONE=${ZONE:-us-central1-a}
MACHINE_TYPE=${MACHINE_TYPE:-a3-highgpu-1g}
ACCELERATOR=${ACCELERATOR:-type=nvidia-h100-80gb,count=1,gpu-driver-version=disabled}
NUM_NODES=${NUM_NODES:-1}
RELEASE_CHANNEL=${RELEASE_CHANNEL:-rapid}

command -v gcloud >/dev/null || { echo "gcloud required" >&2; exit 1; }

echo ">> creating cluster $CLUSTER_NAME in $ZONE"
gcloud container clusters create "$CLUSTER_NAME" \
  --project "$GCP_PROJECT" --zone "$ZONE" \
  --release-channel "$RELEASE_CHANNEL" \
  --num-nodes 1 --machine-type e2-standard-4

echo ">> adding GPU node pool ($MACHINE_TYPE, accelerator $ACCELERATOR)"
gcloud container node-pools create gpu-pool \
  --project "$GCP_PROJECT" --zone "$ZONE" --cluster "$CLUSTER_NAME" \
  --machine-type "$MACHINE_TYPE" \
  --accelerator "$ACCELERATOR" \
  --num-nodes "$NUM_NODES"

gcloud container clusters get-credentials "$CLUSTER_NAME" \
  --project "$GCP_PROJECT" --zone "$ZONE"

echo ">> cluster ready; run: tpu_operator_torch/e2e/local.sh defaults"
