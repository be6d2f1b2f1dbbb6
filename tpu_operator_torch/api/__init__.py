"""The port's API types (``v1``: the ClusterPolicy CRD)."""
