"""The precision one step below the configuration's, for the controls.

bf16 operands go to fp8 (e4m3, scaled per tensor by its largest
magnitude, as fp8 paths scale them); f32 data goes to bf16.
"""

import torch

FP8_MAX = 448.0  # the largest finite e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through e4m3 with a per-tensor scale, back in f32."""
    xf = x.float()
    scale = FP8_MAX / xf.abs().amax().clamp_min(1e-30)
    return (xf * scale).to(torch.float8_e4m3fn).float() / scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through bf16, back in its own dtype."""
    return x.bfloat16().to(x.dtype)
