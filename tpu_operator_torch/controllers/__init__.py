"""The control plane's node-label readers that the port's node agents
call: slice identity and the workload config."""
