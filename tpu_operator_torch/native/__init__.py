"""Host-side card facts for the node agents: the chip table from NVML or
from the device nodes, ``/proc/driver/nvidia`` and sysfs."""
