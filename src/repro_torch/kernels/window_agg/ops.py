"""Dispatch wrapper for the sliding-window aggregates.

``window_agg()`` is what ``core/windows.aggregate`` calls: the CUDA kernel
(``kernel.window_agg_call``) for tensors on the card, the plain torch
loop (``ref.window_agg_ref``) for tensors on the CPU.  Both give the same
bits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.window_agg.ref import window_agg_ref


def window_agg(values: torch.Tensor, count: torch.Tensor, *,
               use_kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """values: (N, W, C) float32; count: (N,) int32 -> dict of (N, C)
    float32 ``sum``/``mean``/``max``/``min``/``count`` over the first
    ``count`` entries of each window.  ``use_kernel=None`` follows the
    tensors' device; ``False`` runs the plain version on any device."""
    if wants_kernel(use_kernel, values):
        from repro_torch.kernels.window_agg.kernel import window_agg_call
        return window_agg_call(values, count)
    return window_agg_ref(values, count)
