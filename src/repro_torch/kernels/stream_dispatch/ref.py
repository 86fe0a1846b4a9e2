"""Plain torch versions of the stream-dispatch kernels: the CPU path and
the oracle of :mod:`repro_torch.kernels.stream_dispatch.kernel` — the
port of the JAX package's ``stream_dispatch/ref.py``.

``stream_dispatch_ref`` computes what the JAX **op**
``repro.kernels.stream_dispatch.ops.stream_dispatch`` computes, which
differs from the JAX package's own ``stream_dispatch_ref`` in two
places: a valid event whose sid lies outside ``out_table`` has no
targets (the JAX ref clamps the sid, and against the row count of
``timestamps``), and a target outside ``timestamps`` compares against a
timestamp of 0 (the JAX ref clamps the target).  On the engine's inputs
(sids and targets in range) the two agree.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def onehot_gather_ref(table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """table: (N, F) int32 or float32; ids: (M,) int -> (M, F) float32:
    row ``ids[m]`` of ``table`` where ``0 <= ids[m] < N``, else a row of
    +0.0.  Float rows keep their bits (-0.0, NaN payloads, subnormals);
    int32 rows round to float32 (exact below 2**24)."""
    N = table.shape[0]
    ok = (ids >= 0) & (ids < N)
    rows = table[torch.clamp(ids, 0, N - 1).long()]
    return torch.where(ok[:, None], rows.to(torch.float32), 0.0)


def by_sid_snapshot_ref(values: Sequence[torch.Tensor],
                        timestamps: Sequence[torch.Tensor], ids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded round's by-sid snapshot: the S shards' ``values`` (L, C)
    and ``timestamps`` (L,) int32 planes stacked into one flat (S L) row
    space and gathered at ``ids`` (M,) -> ``(values_by_sid (M, C) float32,
    ts_by_sid (M,) int32)``.  Rows keep their bits; an id outside
    [0, S L) reads zeros in both (the engine's ``sid_to_flat`` holds
    none)."""
    S, (L, C) = len(values), values[0].shape
    vals = onehot_gather_ref(torch.stack(list(values)).reshape(S * L, C), ids)
    ts_all = torch.stack(list(timestamps)).reshape(S * L)
    ok = (ids >= 0) & (ids < S * L)
    ts = torch.where(ok, ts_all[torch.clamp(ids, 0, S * L - 1).long()], 0)
    return vals, ts


def stream_dispatch_ref(sid, ts, valid, out_table, timestamps, *,
                        with_early: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Subscriber fan-out plus the optional early stale mask.

    sid/ts/valid: (B,); out_table: (n_tab, F) int32 (-1 pad);
    timestamps: (N,) int32.  Returns targets (B, F) int32 — ``out_table
    [sid, f]`` where the event is valid, ``0 <= sid < n_tab`` and the
    entry is ``>= 0``, else -1 — and the early-keep mask (B, F) bool,
    ``target >= 0 & ts > timestamps[target]`` with a timestamp of 0 for
    a target ``>= N``; ``None`` in the mask's place with
    ``with_early=False``."""
    n_tab, N = out_table.shape[0], timestamps.shape[0]
    ok = valid & (sid >= 0) & (sid < n_tab)
    rows = out_table[torch.clamp(sid, 0, n_tab - 1).long()]
    targets = torch.where(ok[:, None] & (rows >= 0), rows, -1)
    if not with_early:
        return targets, None
    tvalid = targets >= 0
    t_ts = timestamps[torch.clamp(targets, 0, N - 1).long()]
    t_ts = torch.where(tvalid & (targets < N), t_ts, 0)
    return targets, tvalid & (ts[:, None] > t_ts)
