"""Dispatch wrappers for the stream-dispatch kernels: the CUDA kernels of
``kernel.py`` for tensors on the card, the plain torch versions of
``ref.py`` for tensors on the CPU (or anywhere with ``use_kernel=False``).

* ``stream_dispatch`` — stage 1 of the round, the subscriber fan-out
  with the optional early stale mask, in one launch; ``make_fanout()``
  wraps it as a drop-in ``fanout_fn`` for the engines
  (``create_engine(reg, fanout_fn=make_fanout())``), like the JAX
  package's ``repro.kernels.stream_dispatch.ops.make_fanout``.
* ``onehot_gather`` — the row gather with zero rows for out-of-range
  ids; the sharded round reads its by-sid snapshot of stream values
  through it.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.stream_dispatch.ref import (onehot_gather_ref,
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
