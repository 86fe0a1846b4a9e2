"""Dispatch wrappers for the stream-dispatch kernels: the CUDA kernels of
``kernel.py`` for tensors on the card, the plain torch versions of
``ref.py`` for tensors on the CPU (or anywhere with ``use_kernel=False``).

* ``stream_dispatch`` — stage 1 of the round, the subscriber fan-out
  with the optional early stale mask, in one launch; ``make_fanout()``
  wraps it as a drop-in ``fanout_fn`` for the engines
  (``create_engine(reg, fanout_fn=make_fanout())``), like the JAX
  package's ``repro.kernels.stream_dispatch.ops.make_fanout``.
* ``onehot_gather`` — the row gather with zero rows for out-of-range
  ids.
* ``by_sid_snapshot`` — the same gather over the S shards' value and
  timestamp planes, read in place, in one launch: the sharded round's
  by-sid snapshot.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.stream_dispatch.ref import (by_sid_snapshot_ref,
                                                     onehot_gather_ref,
                                                     stream_dispatch_ref)


def onehot_gather(table: torch.Tensor, ids: torch.Tensor, *,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """table: (N, F) int32 or float32; ids: (M,) int32 -> (M, F) float32,
    zero rows for ids outside [0, N).  ``use_kernel=None`` follows the
    table's device; ``False`` runs the plain version on any device."""
    if wants_kernel(use_kernel, table):
        from repro_torch.kernels.stream_dispatch.kernel import \
            onehot_gather_call
        return onehot_gather_call(table, ids)
    return onehot_gather_ref(table, ids)


def by_sid_snapshot(values: Sequence[torch.Tensor],
                    timestamps: Sequence[torch.Tensor], ids: torch.Tensor, *,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The by-sid snapshot of S shards (semantics:
    ``ref.by_sid_snapshot_ref``): ``values`` (L, C) float32 and
    ``timestamps`` (L,) int32 per shard, ``ids`` (M,) into their flat
    (S L) rows -> ((M, C) float32, (M,) int32).  ``use_kernel=None``
    follows the first value plane's device; ``False`` runs the plain
    version on any device."""
    if wants_kernel(use_kernel, values[0]):
        from repro_torch.kernels.stream_dispatch.kernel import \
            by_sid_snapshot_call
        return by_sid_snapshot_call(values, timestamps, ids)
    return by_sid_snapshot_ref(values, timestamps, ids)


def stream_dispatch(sid, ts, valid, out_table, timestamps, *,
                    with_early: bool = True,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Subscriber fan-out and optional early stale mask (semantics:
    ``ref.stream_dispatch_ref``).  ``use_kernel=None`` follows
    ``out_table``'s device; ``False`` runs the plain version on any
    device."""
    if wants_kernel(use_kernel, out_table):
        from repro_torch.kernels.stream_dispatch.kernel import \
            stream_dispatch_call
        return stream_dispatch_call(sid, ts, valid, out_table, timestamps,
                                    with_early=with_early)
    return stream_dispatch_ref(sid, ts, valid, out_table, timestamps,
                               with_early=with_early)


def make_fanout(use_kernel: Optional[bool] = None) -> Callable:
    """A ``fanout_fn`` for the round builders and engines, with the
    signature of :func:`repro_torch.core.engine.fanout_reference`, that
    runs :func:`stream_dispatch`."""
    def fanout(sid, ts, pvalid, out_table, timestamps, *, with_early=True):
        return stream_dispatch(sid, ts, pvalid, out_table, timestamps,
                               with_early=with_early, use_kernel=use_kernel)
    return fanout
