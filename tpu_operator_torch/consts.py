"""Host paths and status-file names the port's validator writes.

The barrier directory and file-name convention are the same as the JAX
package's (``tpu_operator/consts.py``); the port keeps its own copy so it
imports nothing from there.
"""

# status-file barrier directory
VALIDATION_DIR = "/run/tpu/validations"
STATUS_FILE_CUDA = "cuda-ready"
STATUS_FILE_MEMBW = "membw-ready"
STATUS_FILE_FLASHATTN = "flashattn-ready"
STATUS_FILE_SLICE = "slice-ready"
STATUS_FILE_SLICE_WORKLOAD = "slice-workload-ready"
STATUS_FILE_ICI = "ici-ready"
STATUS_FILE_RINGATTN = "ringattn-ready"
STATUS_FILE_PIPELINE = "pipeline-ready"
STATUS_FILE_MOE = "moe-ready"
# diagnostic probes (opt-in / on-demand): surfaced by the node-status
# exporter as tpu_validator_probe_ready{probe=...}
PROBE_STATUS_FILES = (
    "slice-ready",
    "slice-workload-ready",
    "ici-ready",
    "ringattn-ready",
    "pipeline-ready",
    "moe-ready",
    "membw-ready",
    "flashattn-ready",
)
