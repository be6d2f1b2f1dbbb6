"""The Kubernetes verbs the port's validator uses: an in-cluster REST
client on the standard library and the conflict-retried update."""
