"""Dispatch wrapper of the Mamba selective scan.

``selective_scan()`` is what the model plane's ``ssm_scan`` calls: the
CUDA kernel (``kernel.selective_scan_call``) for tensors on the card, the
plain torch version (``ref.selective_scan_ref``) for tensors on the CPU
or with ``use_kernel=False``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor, *, use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, bx: (B, L, Di, S); c: (B, L, S); h0: (B, Di, S) -> y (B, L, Di)
    and the final state (B, Di, S), float32."""
    if wants_kernel(use_kernel, a):
        from repro_torch.kernels.selective_scan.kernel import (
            selective_scan_call)
        return selective_scan_call(a, bx, c, h0)
    return selective_scan_ref(a, bx, c, h0)
