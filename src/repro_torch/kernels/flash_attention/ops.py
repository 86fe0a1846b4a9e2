"""Dispatch wrapper of causal / sliding-window GQA attention.

``flash_attention_blhd()``, in the model plane's (B, L, H, Dh) layout, is
what ``attention_block`` calls: the CUDA kernel
(``kernel.flash_attention_call``) for tensors on the card, the plain torch
version (``ref.attention_ref``) for tensors on the CPU or with
``use_kernel=False``.  Neither computes a logit soft cap or a query offset
(cached continuation), so it raises ``ValueError`` for them rather than
compute another function.

With an input that requires grad (training), the call goes through
:class:`FlashAttentionFn`: the same forward, and as backward the gradient
of the plain version, recomputed from the saved q, k and v.  The JAX
package has no backward kernel either: its training differentiates the
plain jnp attention, so that gradient is the reference's.  A kernel for
the backward is performance work.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def _plain(q, k, v, window):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), window=window
                         ).transpose(1, 2).to(q.dtype)


def _attend(q, k, v, window, use_kernel):
    """(B, L, H, Dh) attention in q's dtype: the kernel or the plain
    version, as ``use_kernel`` and the device say."""
    if wants_kernel(use_kernel, q):
        from repro_torch.kernels.flash_attention.kernel import (
            flash_attention_call)
        return flash_attention_call(q, k, v, window=window)
    return _plain(q, k, v, window)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient.  Forward: the kernel on the card (its
    plain version on the CPU or with ``use_kernel=False``); it saves q, k
    and v.  Backward: the plain version's gradient — ``attention_ref``
    recomputed on the saved inputs under autograd, then
    ``torch.autograd.grad`` with the incoming gradient — which
    materialises one layer's (B, KV, G, L, L) float32 scores at a time.
    That is the function ``repro``'s training differentiates; it is the
    design here, not a fallback."""

    @staticmethod
    def forward(ctx, q, k, v, window, use_kernel):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return _attend(q, k, v, window, use_kernel)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = _plain(*ins, ctx.window)
            got = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], g))
        return (*(next(got) if n else None for n in need), None, None)


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q (B, L, H, Dh); k/v (B, S, KV, Dh) -> (B, L, H*Dh) in q's dtype.
    The kernel reads any strides in place, so (B, H, L, Dh) tensors go in
    as ``t.transpose(1, 2)``.  ``use_kernel=None`` follows the tensors'
    device; ``False`` runs the plain version on any device.  With grad
    enabled and an input that requires it, :class:`FlashAttentionFn`
    carries the gradient; otherwise nothing is saved."""
    if softcap is not None:
        raise ValueError("flash_attention has no logit soft cap "
                         f"(attn_logit_softcap={softcap})")
    if q_offset:
        raise ValueError("flash_attention serves prefill from position 0; "
                         f"q_offset={q_offset}")
    B, L, H, Dh = q.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttentionFn.apply(q, k, v, window, use_kernel)
    else:
        out = _attend(q, k, v, window, use_kernel)
    return out.reshape(B, L, H * Dh)
