"""Sliding-window aggregators (the paper's §VII future work) — the
PyTorch port of the JAX package's ``repro.core.windows``.

A :class:`WindowStore` keeps, per stream, a ring buffer of the last W
emitted Sensor Updates (values + timestamps).  Pushes are O(1) scatters
batched per engine round; aggregates (sum/mean/max/min/count) come for
*all* streams in one pass (:mod:`repro_torch.kernels.window_agg`, the
CUDA kernel on the card), either over the last-W-events window or a
time-interval window (ts > horizon, plain torch as in the JAX package).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.engine import _add_drop, _set_drop2, _take
from repro_torch.kernels.window_agg.ops import window_agg
from repro_torch.kernels.window_agg.ref import masked_agg

I32_MIN = torch.iinfo(torch.int32).min


class WindowStore(NamedTuple):
    values: torch.Tensor    # (N, W, C) ring buffers
    ts: torch.Tensor        # (N, W) int32 entry timestamps
    ptr: torch.Tensor       # (N,) next write slot (kept below 2W)
    total: torch.Tensor     # (N,) total pushes (count = min(total, W))


def init_window_store(n_streams: int, window: int, channels: int,
                      device="cuda") -> WindowStore:
    """Empty rings of ``window`` entries for ``n_streams`` streams on
    ``device``."""
    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return WindowStore(
        values=z((n_streams, window, channels), torch.float32),
        ts=torch.full((n_streams, window), I32_MIN, dtype=torch.int32,
                      device=device),
        ptr=z((n_streams,)), total=z((n_streams,)))


def push(store: WindowStore, sid: torch.Tensor, vals: torch.Tensor,
         ts: torch.Tensor, mask: torch.Tensor) -> WindowStore:
    """Batched O(1) ring insert of one engine round's emissions.

    sid: (B,), vals: (B, C), ts: (B,), mask: (B,) bool.  At most one SU
    per stream per round (the engine's coalescing guarantees it); masked
    lanes are dropped."""
    N, W, _ = store.values.shape
    row = torch.where(mask, sid, N)                 # N = dropped lane
    slot = _take(store.ptr, torch.clamp(sid, 0, N - 1)) % W
    values = _set_drop2(store.values, row, slot, vals.to(torch.float32))
    tss = _set_drop2(store.ts, row, slot, ts.to(torch.int32))
    ptr = _add_drop(store.ptr, row, 1)
    total = _add_drop(store.total, row, 1)
    return WindowStore(values, tss, ptr % (2 * W), total)


def reset_rows(store: WindowStore, sid) -> WindowStore:
    """Clear stream ``sid``'s ring buffer (an int or a (K,) batch of
    sids), so that a revoked stream's window history does not leak into a
    readmission of its recycled sid."""
    idx = torch.as_tensor(sid, device=store.values.device).long()
    values, tss = store.values.clone(), store.ts.clone()
    ptr, total = store.ptr.clone(), store.total.clone()
    values[idx] = 0.0
    tss[idx] = I32_MIN
    ptr[idx] = 0
    total[idx] = 0
    return WindowStore(values, tss, ptr, total)


def aggregate(store: WindowStore, *, horizon: Optional[int] = None,
              use_kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """All five aggregates for every stream, (N, C) each.

    ``horizon``: if given, restrict to entries with ts > horizon (the
    paper's time-interval windows, plain torch); otherwise the
    last-W-events window through ``window_agg`` (``use_kernel`` as there:
    None follows the store's device)."""
    N, W, C = store.values.shape
    count = torch.clamp(store.total, max=W)
    if horizon is not None:
        valid = (store.ts > horizon) & (
            torch.arange(W, device=count.device)[None, :] < count[:, None])
        return masked_agg(store.values, valid)
    return window_agg(store.values, count, use_kernel=use_kernel)
