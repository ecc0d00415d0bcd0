"""Plain PyTorch version of the ``gram`` kernel — counterpart of
``repro/kernels/gram/ref.py``: the oracle the kernel is held against on the
card, and what the wrapper runs for CPU tensors."""
import torch


def gram_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """G = X Y^T in fp32."""
    return x.float() @ y.float().T
