"""Peak rates of the cards the port measures against.

NVIDIA H100 datasheet figures, dense (no sparsity), keyed by the variant
tag that ``workloads.matmul.device_generation`` returns. They assume the
card's full power limit; a card set below it runs slower under load.
"""

# single-card peak bf16 tensor-core TFLOPS
PEAK_BF16_TFLOPS = {"h100-sxm": 989.0, "h100-pcie": 756.0, "h100-nvl": 835.0}

# device-memory bandwidth GB/s per card
PEAK_HBM_GBPS = {"h100-sxm": 3350.0, "h100-pcie": 2000.0, "h100-nvl": 3900.0}
