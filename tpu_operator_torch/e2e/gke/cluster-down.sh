#!/usr/bin/env bash
# Tear down the e2e cluster created by cluster-up.sh.
set -euo pipefail

: "${GCP_PROJECT:?set GCP_PROJECT}"
CLUSTER_NAME=${CLUSTER_NAME:-gpu-operator-e2e}
ZONE=${ZONE:-us-central1-a}

gcloud container clusters delete "$CLUSTER_NAME" \
  --project "$GCP_PROJECT" --zone "$ZONE" --quiet
