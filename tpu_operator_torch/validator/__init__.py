"""The port's validator: components and the CLI for the compute chain
and the multi-device probes."""
