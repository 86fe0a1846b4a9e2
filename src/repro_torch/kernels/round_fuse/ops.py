"""Dispatch wrappers for the round-fusion plane: the CUDA kernels of
``kernel.py`` for tensors on the card, the plain torch refs for tensors
on the CPU (or anywhere with ``use_kernel=False``).

* ``fused_stages``     — single-device stages 1-3 (engine ``make_step``
  with ``fused_round`` on).
* ``apply_programs``   — stages 2+3 alone (the sharded round, after the
  exchange), every shard at once.
* ``exchange_compact`` — the sharded exchange's ranked-scatter
  compaction, every sending shard at once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.round_fuse.ref import (
    RegLayout, apply_programs_ref, exchange_compact_ref, pop_dispatch_ref)


def fused_stages(prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts,
                 batch: int, out_table, in_table, progs, consts,
                 is_composite, active, values, timestamps,
                 layout: RegLayout, *, use_kernel: Optional[bool] = None):
    """Stages 1-3 of the single-device round as one operation: packed
    top-``batch`` pop, fan-out, co-input fetch + reduced-branch VM, and
    the Listing-2 window gate.  Per-slot planes as in ``sched_pop``; the
    tables/state leaves are the engine's (N, ...) tensors.  Returns
    ``(take, (e_sid, e_vals, e_ts, e_pop, e_act), wi_t, (new_vals,
    ts_out, live, keep, keep_ts, passf, badf))`` — wi_t already -1 for
    invalid/revoked lanes, so ``wi_t >= 0`` is the work-item validity
    mask."""
    if wants_kernel(use_kernel, vals):
        from repro_torch.kernels.round_fuse.kernel import fused_round_call
        return fused_round_call(prio_slot, seq, valid, t_slot, w_slot, sid,
                                vals, ts, batch, out_table, in_table, progs,
                                consts, is_composite, active, values,
                                timestamps, layout)
    take, popped, (wi_t, wi_src, wi_vals, wi_ts) = pop_dispatch_ref(
        prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts, batch,
        out_table, active)
    N = out_table.shape[0]
    rows = torch.clamp(wi_t, 0, N - 1)
    applied = apply_programs_ref(
        layout, in_table, progs, consts, is_composite, active,
        rows, rows, wi_src, wi_vals, wi_ts, wi_t >= 0, values, timestamps)
    return take, popped, wi_t, applied


def _per_shard(fn, *args):
    """``fn`` over the leading shard axis of every tensor argument, its
    outputs stacked back."""
    S = next(a.shape[0] for a in args if isinstance(a, torch.Tensor))
    outs = [fn(*(a[s] if isinstance(a, torch.Tensor) else a for a in args))
            for s in range(S)]
    return tuple(torch.stack(o) for o in zip(*outs))


def apply_programs(layout: RegLayout, in_table, progs, consts, is_composite,
                   active, rows, t_sid, wi_src, wi_vals, wi_ts, wi_valid,
                   values_by_sid, timestamps_by_sid, *,
                   use_kernel: Optional[bool] = None):
    """Stages 2+3 for a work-item batch — ``engine.process_work_items``
    with the reduced-branch VM, returning the raw masks ``(new_vals,
    ts_out, live, keep, keep_ts, passf, badf)``, each with the leading
    shard axis.  Tables are (S, n_tab, ...) with (S, W) items (the sharded
    round: each shard's items against its own table slice); ``rows``
    index the tables, ``t_sid`` the shared value/timestamp snapshot, whose
    row space may differ from the tables'."""
    if wants_kernel(use_kernel, wi_vals):
        from repro_torch.kernels.round_fuse.kernel import apply_programs_call
        return apply_programs_call(layout, in_table, progs, consts,
                                   is_composite, active, rows, t_sid, wi_src,
                                   wi_vals, wi_ts, wi_valid, values_by_sid,
                                   timestamps_by_sid)
    return _per_shard(
        lambda *a: apply_programs_ref(layout, *a, values_by_sid,
                                      timestamps_by_sid),
        in_table, progs, consts, is_composite, active, rows, t_sid,
        wi_src, wi_vals, wi_ts, wi_valid)


def exchange_compact(wi_t, wi_src, wi_ts, wi_its, wi_vals, dest_shard,
                     n_shards: int, slots: int, *,
                     use_kernel: Optional[bool] = None):
    """Rank-and-scatter work items into (n_shards, slots) exchange
    buckets, array order kept per destination; ``dest_shard == n_shards``
    marks unrouted lanes.  Items are (S, W) planes of S senders.  Returns
    ``(xi, xf, x_drop)``: int32 ``(target, src, ts, its)`` buckets
    -1-padded, float32 payloads and the overflow mask, each with the
    senders' leading axis."""
    if wants_kernel(use_kernel, wi_vals):
        from repro_torch.kernels.round_fuse.kernel import \
            exchange_compact_call
        return exchange_compact_call(wi_t, wi_src, wi_ts, wi_its, wi_vals,
                                     dest_shard, n_shards, slots)
    return _per_shard(
        lambda *a: exchange_compact_ref(*a, n_shards, slots),
        wi_t, wi_src, wi_ts, wi_its, wi_vals, dest_shard)
