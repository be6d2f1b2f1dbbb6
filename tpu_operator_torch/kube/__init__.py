"""The Kubernetes verbs the port's node agents use: an in-cluster REST
client on the standard library, the conflict-retried update, the pod-spec
predicate of the pod sweeps and eviction through the Eviction
subresource."""
