"""Plain references of what the validator's kernels compute.

Plain PyTorch, written from the operations' definitions. They import
nothing of the program, and take from it only the outputs they judge.
Each reference takes ``lower=True`` for the control: the same function
computed one precision below the one the configuration states.
"""

import torch


def exact_matmuls() -> None:
    """Keep TF32 out of the references' f32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
