"""The control plane's node-label readers that the port's node agents
call: slice identity, the workload config and the card variant."""
