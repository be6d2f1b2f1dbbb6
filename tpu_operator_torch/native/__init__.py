"""Host-side card facts for the node agents: the chip table from NVML or
from the device nodes, ``/proc/driver/nvidia`` and sysfs (``gpuinfo.py``),
and the native programs under ``csrc/`` that ``build.py`` compiles: the
card probe ``libgpuinfo.so``, the startup probe ``gpu_smoke`` and the
metrics hostengine ``gpu_metricsd``."""
