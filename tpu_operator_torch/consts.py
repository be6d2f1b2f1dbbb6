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
