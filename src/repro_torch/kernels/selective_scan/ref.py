"""Plain torch version of the Mamba selective-scan recurrence: the CPU
path and the oracle of :mod:`repro_torch.kernels.selective_scan.kernel`
— the port of the JAX package's sequential ``selective_scan/ref.py``."""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                       h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, bx: (B, L, Di, S); c: (B, L, S); h0: (B, Di, S).  h_t = a_t *
    h_{t-1} + bx_t, y_t = h_t . c_t over S.  Returns y (B, L, Di) and the
    final state (B, Di, S), float32.  Every state h_t is kept (a tensor
    of a's size), so the loop over time is two elementwise launches a
    step and the contraction with c is one batched product.  With grad
    enabled and an input that requires it, the states are stacked from
    the loop instead of written in place, so autograd runs through the
    loop (the plain version's gradient); the values are the same.  The
    steps' inputs come from one ``unbind`` each, whose backward stacks
    their gradients once (indexing a step would give every step's
    backward a full-size zero tensor)."""
    a, bx, c = a.float(), bx.float(), c.float()
    h = h0.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a, bx, c, h)):
        hs = []
        for a_t, bx_t in zip(a.unbind(1), bx.unbind(1)):
            h = a_t * h + bx_t
            hs.append(h)
        return torch.einsum("blds,bls->bld", torch.stack(hs, 1), c), h
    h_all = torch.empty_like(a)
    for t in range(a.shape[1]):
        torch.mul(a[:, t], h, out=h_all[:, t])
        h = h_all[:, t]
        h += bx[:, t]
    y = torch.einsum("blds,bls->bld", h_all, c)
    return y, h.clone()
