"""Chronological-consistency rules (paper §IV-D, Listing 2), vectorized —
the PyTorch port of the JAX package's ``repro.core.consistency``.

The paper's algorithm, per triggering Sensor Update:

    previousSelf = last update of the composite stream itself
    if received.ts <= previousSelf.ts:  return null          (discard)
    queried      = last updates of the remaining input streams
    ts_out       = max(ts of received, previousSelf, queried...)
    emit f(inputs) with timestamp ts_out

The *relaxed* restriction (only the triggering element is checked) is what
makes the model lock-free: nothing ever waits for co-inputs, stale
deliveries are simply discarded.

All functions operate on whole work-item batches.
"""
from __future__ import annotations

from typing import Optional

import torch

I32_MIN = torch.iinfo(torch.int32).min
I32_MAX = torch.iinfo(torch.int32).max


def keep_mask(ts_recv: torch.Tensor, ts_prev_self: torch.Tensor
              ) -> torch.Tensor:
    """Listing 2 discard rule: keep iff the trigger is strictly newer than
    the stream's own last emission.  (W,) bool."""
    return ts_recv > ts_prev_self


def output_timestamp(
    ts_recv: torch.Tensor,          # (W,)
    ts_prev_self: torch.Tensor,     # (W,)
    ts_inputs: torch.Tensor,        # (W, M) timestamps of gathered co-inputs
    input_valid: torch.Tensor,      # (W, M) bool — real subscription slots
) -> torch.Tensor:
    """ts_out = max over {received, previousSelf, queried co-inputs}."""
    masked = torch.where(input_valid, ts_inputs,
                         torch.full_like(ts_inputs, I32_MIN))
    return torch.maximum(torch.maximum(ts_recv, ts_prev_self),
                         masked.max(dim=-1).values)


def resolve_winners(
    targets: torch.Tensor,      # (W,) int32 target stream id (may repeat)
    ts_out: torch.Tensor,       # (W,) proposed output timestamps
    keep: torch.Tensor,         # (W,) bool — passed the discard rule + filters
    n_streams: int,
    order: Optional[torch.Tensor] = None,  # (W,) optional tie key (lower wins)
) -> torch.Tensor:
    """Intra-round coalescing: per target the kept item with the newest
    ``ts_out`` wins; equal-``ts_out`` ties break on ``order`` (lowest
    wins) when given, then on lowest work index.  ``targets`` must lie in
    ``[0, n_streams)``; row ``n_streams`` parks the losers.  The three
    scatters are max/min reductions, so repeated targets resolve the same
    way on every device.  Returns (W,) bool winner mask."""
    W = targets.shape[0]
    dev = targets.device
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    tgt = torch.where(keep, targets, n_streams).long()   # parked row for losers

    best_ts = torch.full((n_streams + 1,), I32_MIN, dtype=ts_out.dtype,
                         device=dev)
    best_ts = best_ts.scatter_reduce(
        0, tgt, torch.where(keep, ts_out, I32_MIN), "amax", include_self=True)
    is_best = keep & (ts_out == best_ts[tgt])

    if order is not None:
        best_ord = torch.full((n_streams + 1,), I32_MAX, dtype=torch.int32,
                              device=dev)
        best_ord = best_ord.scatter_reduce(
            0, tgt, torch.where(is_best, order, I32_MAX).to(torch.int32),
            "amin", include_self=True)
        is_best = is_best & (order == best_ord[tgt])

    first_idx = torch.full((n_streams + 1,), W, dtype=torch.int32, device=dev)
    first_idx = first_idx.scatter_reduce(
        0, tgt, torch.where(is_best, idx, W).to(torch.int32), "amin",
        include_self=True)
    return is_best & (idx == first_idx[tgt])
