"""``gpuop-cfg``: the ClusterPolicy's schema validation, CRD generation
and the config CLI (``main.py``). PyYAML is imported only where a file is
read or written."""
