"""Dispatch wrapper of the Mamba selective scan.

``selective_scan()`` is what the model plane's ``ssm_scan`` calls: the
CUDA kernel (``kernel.selective_scan_call``) for tensors on the card, the
plain torch version (``ref.selective_scan_ref``) for tensors on the CPU
or with ``use_kernel=False``.

With an input that requires grad (training), the call goes through
:class:`SelectiveScanFn`, whose backward is the JAX package's own
adjoint recurrence (``repro.models.ssm._seq_scan_bwd``) in plain torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def chunk_len(chunk: Optional[int], L: int) -> int:
    """``repro``'s chunk rule: ``min(chunk, L)``, or the whole sequence
    when that does not divide L (or no chunk is given)."""
    ck = min(chunk or L, L)
    return L if L % ck else ck


def _scan(a, bx, c, h0, use_kernel):
    if wants_kernel(use_kernel, a):
        from repro_torch.kernels.selective_scan.kernel import (
            selective_scan_call)
        return selective_scan_call(a, bx, c, h0)
    return selective_scan_ref(a, bx, c, h0)


class SelectiveScanFn(torch.autograd.Function):
    """The scan with a gradient.  Forward: the kernel (its plain version
    on the CPU or with ``use_kernel=False``) once per chunk of ``chunk``
    steps, each chunk starting from the state the last one left through
    the kernel's own ``h0``; the chunks' input states are saved (the
    kernel returns no intermediate states).  Backward: the adjoint
    recurrence of ``repro``'s ``_seq_scan_bwd`` in plain torch on the
    inputs' device: per chunk, last first, h recomputed from the chunk's
    input state, then

        total_t = lam_t + c_t gy_t;  ga_t = total_t h_{t-1};
        gbx_t = total_t;  lam_{t-1} = a_t total_t,

    with gc from y's contraction and the gradient of h0 the last lam.
    ``repro``'s ``ssm_mode="assoc"`` differentiates its associative scan,
    the same function, so this serves both modes.  The JAX package has no
    backward kernel; a kernel for this recurrence is performance work."""

    @staticmethod
    def forward(ctx, a, bx, c, h0, chunk, use_kernel):
        L = a.shape[1]
        ck = chunk_len(chunk, L)
        ys, bounds, h = [], [], h0.float()
        for t0 in range(0, L, ck):
            bounds.append(h)
            sl = slice(t0, t0 + ck)
            y, h = _scan(a[:, sl], bx[:, sl], c[:, sl], h, use_kernel)
            ys.append(y)
        ctx.ck = ck
        ctx.save_for_backward(a, bx, c, torch.stack(bounds))
        return torch.cat(ys, 1) if len(ys) > 1 else ys[0], h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gh):
        a, bx, c, bounds = (t.float() for t in ctx.saved_tensors)
        B, L, Di, S = a.shape
        ck = ctx.ck
        gy = gy.float()
        lam = gh.float()
        ga = torch.empty_like(a)
        gbx = torch.empty_like(a)
        gc = torch.empty_like(c)
        hs = torch.empty((B, ck, Di, S), dtype=torch.float32, device=a.device)
        for i in reversed(range(L // ck)):
            t0 = i * ck
            h = bounds[i]
            for t in range(ck):                   # recompute the chunk's h
                h = torch.mul(a[:, t0 + t], h, out=hs[:, t])
                h += bx[:, t0 + t]
            for t in reversed(range(ck)):         # the adjoint, backwards
                total = gbx[:, t0 + t]
                torch.mul(c[:, t0 + t, None, :], gy[:, t0 + t, :, None],
                          out=total)
                total += lam
                torch.mul(total, hs[:, t - 1] if t else bounds[i],
                          out=ga[:, t0 + t])
                lam = a[:, t0 + t] * total
            gc[:, t0:t0 + ck] = torch.einsum(
                "bld,blds->bls", gy[:, t0:t0 + ck], hs)
        return ga, gbx, gc, lam, None, None


def selective_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor, *, chunk: Optional[int] = None,
                   use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, bx: (B, L, Di, S); c: (B, L, S); h0: (B, Di, S) -> y (B, L, Di)
    and the final state (B, Di, S), float32.  With grad enabled and an
    input that requires it, :class:`SelectiveScanFn` carries the gradient
    and ``chunk`` sets its recompute chunk (``repro``'s ``ssm_chunk``);
    otherwise the scan is one launch and ``chunk`` is not read."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a, bx, c, h0)):
        return SelectiveScanFn.apply(a, bx, c, h0, chunk, use_kernel)
    return _scan(a, bx, c, h0, use_kernel)
