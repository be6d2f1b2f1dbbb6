"""PyTorch port of tpu-operator's compute chain for NVIDIA H100 cards
(sm_90a).

The validator's chain runs here as it does in ``tpu_operator``: the bf16
matmul chain (``workloads/matmul.py``), the HBM bandwidth probe
(``workloads/membw.py``) and the flash-attention probe
(``workloads/flashattn.py``), reached through ``validator/`` and the
``python -m tpu_operator_torch.validator`` CLI. The copy and attention
kernels are CUDA C++ under ``csrc/``, built at first use by ``_build.py``.
The multi-device path (``entry.dryrun_multichip`` and the validator's
``slice``, ``ici``, ``ringattn``, ``pipeline`` and ``moe`` components) runs
a world of processes over ``torch.distributed`` (``workloads/mesh.py``):
NCCL, one card a rank, or gloo on the CPU; it launches none of the
package's kernels. The node agents (the validator's host checks and
workload pods, the node-status exporter in ``validator/metrics.py``, the
metrics daemon in ``metricsd/``) read the card through ``native/gpuinfo.py``
(the native library ``libgpuinfo.so`` where ``native/build.py`` built it,
else NVML through ``ctypes``; without NVML the device nodes and sysfs; the
daemon hands serving to the native hostengine) and launch none either, nor do the
agents that advertise the cards to the kubelet: the CDI spec and its
runtime wire (``plugin/cdi.py``, ``operands/runtime_wire.py``), the device
plugin (``plugin/``, over the kubelet's gRPC API) and feature discovery
(``discovery/``), placed by ``workloads/topology.py``, nor the node's
partition and telemetry operands: the slice manager (``sliceman/``), the
metrics exporter (``exporter/``) and the driver, driver-manager, vfio and
VM operands (``operands/``), nor the control plane's foundation: the
ClusterPolicy types (``api/v1/``), its schema validation, CRD generation
and the ``gpuop-cfg`` CLI (``cfg/``), and the client stack, KubeSim and
the simulated kubelet (``kube/``), nor the controllers (``controllers/``,
``upgrade/``) and the operator process that runs them off a watch-fed
workqueue (``manager.py``, ``shard.py``, ``main.py``, the ``gpu-operator``
script). ``deploy/`` holds the port's install tree (the Helm chart, the
kustomize base, the OLM bundle, must-gather and the e2e pod), which
``gpuop-cfg`` generates and lints. grpc, protobuf, PyYAML and
``prometheus_client`` are imported only inside the functions that need
them, and grpc by ``kube/kubelet_sim.py``, which nothing imports with the
package.

The package imports ``torch`` and never ``jax`` or ``tpu_operator``.
Entry points run on ``cuda`` unless the caller asks for the CPU, where each
kernel wrapper takes its plain PyTorch version.
"""
