"""The slice manager (the mig-manager slot): partitions a node's cards into
NVLink-contiguous subslices named by a node label."""
