"""Hand-written CUDA kernels of the port, each beside its plain torch
version (``ref.py``) and its dispatch wrapper (``ops.py``).

A wrapper launches the kernel for tensors on a CUDA device and runs the
plain version for tensors on the CPU; ``use_kernel=False`` asks for the
plain version on the card too (the comparison runs of ``chip_smoke.py``).
There is no fallback: a CUDA tensor either reaches its kernel or the
call raises."""
from __future__ import annotations

from typing import Optional

import torch


def wants_kernel(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    """Whether a wrapper launches its CUDA kernel for tensor ``x``:
    ``None`` follows the tensor's device; ``True`` on a CPU tensor
    raises, since the kernel runs only on the card."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("the CUDA kernel takes tensors on a CUDA device")
    return bool(use_kernel)
