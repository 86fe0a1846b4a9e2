"""Plain torch version of the sliding-window aggregates: the CPU path and
the bit-exactness oracle of :mod:`repro_torch.kernels.window_agg.kernel`
— the port of the JAX package's ``window_agg/ref.py``.

Float policy (``core/program.py``): subnormal inputs and results of the
sum and the mean flush to a zero of the same sign, min/max propagate NaN
and order -0.0 below +0.0, and the mean is one correctly rounded
division.  The sum runs over w in index order, adding a zero for every
entry outside the window, exactly as the JAX reference's masked sum
does: the CUDA kernel equals this version bit for bit at every W, and so
does XLA's sequential reduction for W <= 32 (above that XLA sums in
another order).  A one-entry window (W == 1) is its entry, unflushed,
as XLA folds it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.program import flush, maximum, minimum

BIG = 3.0e38
AGGREGATES = ("sum", "mean", "max", "min", "count")


def _agg(values: torch.Tensor, valid: torch.Tensor, count: torch.Tensor
         ) -> Dict[str, torch.Tensor]:
    """The five aggregates over the entries ``valid`` (N, W) marks in
    ``values`` (N, W, C); ``count`` (N,) int is what the mean divides by
    (at least 1) and what the count output and the empty-stream rule
    read."""
    N, W, C = values.shape
    vf = values.to(torch.float32)
    zero = torch.zeros((N, C), dtype=torch.float32, device=vf.device)
    lo = torch.full_like(zero, -BIG)
    hi = torch.full_like(zero, BIG)
    if W == 1:
        # a one-entry window is its entry: XLA folds the reduction of a
        # single element away (no add, no flush), and so does the port
        ok, x = valid[:, :1], vf[:, 0]
        s, mx, mn = (torch.where(ok, x, zero), torch.where(ok, x, lo),
                     torch.where(ok, x, hi))
    else:
        s, mx, mn = zero, lo, hi
        for w in range(W):
            ok = valid[:, w, None]
            x = flush(vf[:, w])
            s = flush(s + torch.where(ok, x, zero))
            mx = maximum(mx, torch.where(ok, x, lo))
            mn = minimum(mn, torch.where(ok, x, hi))
    cf = count.to(torch.float32)[:, None].expand(N, C)
    has = count[:, None] > 0
    return {
        "sum": s,
        "mean": torch.where(has, flush(s / torch.clamp(cf, min=1.0)), zero),
        "max": torch.where(has, mx, zero),
        "min": torch.where(has, mn, zero),
        "count": cf.contiguous(),
    }


def masked_agg(values: torch.Tensor, valid: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """All five aggregates over the entries ``valid`` (N, W) bool marks in
    ``values`` (N, W, C): a dict of (N, C) float32.  A stream with no
    valid entry reads 0 for its mean, max and min."""
    return _agg(values, valid, valid.sum(dim=1, dtype=torch.int32))


def window_agg_ref(values: torch.Tensor, count: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """values: (N, W, C) ring buffers; count: (N,) int32 valid entries
    (<= W).  Returns the dict of (N, C) aggregates over the first
    ``count`` entries of each ring."""
    W = values.shape[1]
    valid = torch.arange(W, device=values.device)[None, :] < count[:, None]
    return _agg(values, valid, count)
