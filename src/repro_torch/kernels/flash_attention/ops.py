"""Dispatch wrapper of causal / sliding-window GQA attention.

``flash_attention_blhd()``, in the model plane's (B, L, H, Dh) layout, is
what ``attention_block`` calls: the CUDA kernel
(``kernel.flash_attention_call``) for tensors on the card, the plain torch
version (``ref.attention_ref``) for tensors on the CPU or with
``use_kernel=False``.  Neither computes a logit soft cap or a query offset
(cached continuation), so it raises ``ValueError`` for them rather than
compute another function.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q (B, L, H, Dh); k/v (B, S, KV, Dh) -> (B, L, H*Dh) in q's dtype.
    The kernel reads any strides in place, so (B, H, L, Dh) tensors go in
    as ``t.transpose(1, 2)``.  ``use_kernel=None`` follows the tensors'
    device; ``False`` runs the plain version on any device."""
    if softcap is not None:
        raise ValueError("flash_attention has no logit soft cap "
                         f"(attn_logit_softcap={softcap})")
    if q_offset:
        raise ValueError("flash_attention serves prefill from position 0; "
                         f"q_offset={q_offset}")
    B, L, H, Dh = q.shape
    if wants_kernel(use_kernel, q):
        from repro_torch.kernels.flash_attention.kernel import (
            flash_attention_call)
        out = flash_attention_call(q, k, v, window=window)
    else:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window
                            ).transpose(1, 2).to(q.dtype)
    return out.reshape(B, L, H * Dh)
