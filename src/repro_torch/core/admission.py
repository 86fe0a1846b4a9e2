"""Dynamic admission plane: live topology churn as in-place table edits —
the PyTorch port of the JAX package's ``repro.core.admission``.

Tenants subscribe and unsubscribe while the engine keeps running, so
churn must never rebuild the round.  Every op here edits the very
:class:`~repro_torch.core.engine.DeviceTables` / ``EngineState`` tensors
the round reads, **in place**: no table or state tensor is reallocated
(its ``data_ptr()`` is the same before and after), which is what a
captured CUDA graph of the round needs.

    admit_stream         claim a spare (``active=False``) row: flags,
                         tenant, priority, VM program; reset its state slice
    revoke_stream        clear the row, scrub every subscription edge that
                         references the sid, purge its queued SUs (counted
                         in ``stats["dropped_revoked"]``, dead-lettered)
    admit_subscription   append one edge: a slot in the target's in-table +
                         the source's fan-out table (dedup on the out side,
                         exactly like ``Registry.build_tables``)
    revoke_subscription  remove one edge occurrence; drop the fan-out entry
                         once no occurrence remains
    swap_program         replace a composite's VM bytecode + constant pool
    migrate_row          move a row (tables + state slice) to another
                         physical slot — the sharded engine's ``rebalance``
    set_weight           one tenant's weighted-fair-pop share
    set_quota            one tenant's ingest token bucket (quota + burst)
    quarantine_stream    flip a stream's quarantined bit and purge its
                         queued SUs to the DLQ as ``poisoned``
    unquarantine_stream  lift a quarantine and reset the breaker window
    set_breaker          the engine-wide breaker knobs [W, F, ceiling]
    reset_windows        clear a stream's window ring buffer
    requeue / requeue_shard
                         enqueue SUs directly, bypassing phase 0 — the
                         retention-replay / dead-letter-redelivery edit
    respool / respool_shard
                         re-append refused dead letters to the spool and
                         count them in ``redeliver_rejected``
    clear_dead_letters   reset the dead-letter spool cursor after a drain

Rows are addressed by an index tuple: ``(sid,)`` on a single device,
``(shard, local)`` against the sharded tables, whose per-tenant tables
and breaker knobs carry one copy per shard (``...``-indexed edits write
every copy).  These are host operations between rounds: they may read
a few values back (the ``ok`` of an edge edit, the rows a purge hits).
The durability plane's edits (``requeue``, ``respool`` and their
``_shard`` forms) run the engine's own enqueue and spool functions on the
state (one shard's views of it for the ``_shard`` forms) and copy what
changed back into the same tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.engine import (DLQ_POISONED, DLQ_REVOKED, FAIR_SCALE,
                                     I32, INT_MIN, QUOTA_MAX, DeviceTables,
                                     EngineState, _enqueue, dlq_append)

# fill value of each *per-stream* table field for a vacated row (the
# images Registry.build_tables produces for rows no stream occupies); the
# per-tenant QoS tables and the breaker knobs are not row-indexed and
# survive every admit/revoke/migrate
_TABLE_FILL = {
    "in_table": -1, "in_count": 0, "out_table": -1, "out_count": 0,
    "progs": 0, "consts": 0.0, "is_composite": False, "tenant": 0,
    "priority": 0, "n_channels": 1, "model_backed": False, "active": False,
}
# per-stream state-slice fills: last value/timestamp, the retention ring
# (a recycled sid never replays its predecessor's emissions) and the
# fault-plane counters (a recycled sid starts with a clean breaker)
_STATE_FILL = {"values": 0.0, "timestamps": INT_MIN,
               "ret_vals": 0.0, "ret_ts": 0, "ret_its": 0, "ret_count": 0,
               "quarantined": False, "fault_count": 0, "fault_epoch": 0,
               "fault_total": 0}


def _clear_row(tables: DeviceTables, row: Tuple) -> None:
    for f, fill in _TABLE_FILL.items():
        getattr(tables, f)[row] = fill


def _reset_state_row(state: EngineState, row: Tuple) -> None:
    for f, fill in _STATE_FILL.items():
        getattr(state, f)[row] = fill


def _dlq_spill(state: EngineState, hit: torch.Tensor, tenant: int,
               reason: int) -> None:
    """Append the queued SUs under ``hit`` ((Q,) or sharded (S, Q)) to the
    dead-letter spool behind ``dlq_fill``, in queue-slot order per shard,
    charged to ``tenant`` — ``engine.dlq_append`` in place.  Letters past
    ``cfg.dlq_slots`` are lost (the stats still count them)."""
    D = state.dlq_sid.shape[-1]
    if D == 0:
        return
    rank = state.dlq_fill[..., None] + torch.cumsum(
        hit.to(torch.int32), -1, dtype=torch.int32) - 1
    ok = hit & (rank < D)
    if hit.dim() == 2:          # sharded: every shard spills to its own DLQ
        shard = torch.arange(hit.shape[0], device=hit.device)[:, None]
        dest = (shard.expand_as(hit)[ok], rank[ok].long())
    else:
        dest = (rank[ok].long(),)
    state.dlq_sid[dest] = state.q_sid[ok]
    state.dlq_vals[dest] = state.q_vals[ok]
    state.dlq_ts[dest] = state.q_ts[ok]
    state.dlq_its[dest] = state.q_its[ok]
    state.dlq_reason[dest] = reason
    state.dlq_tenant[dest] = tenant
    torch.clamp(state.dlq_fill + hit.sum(-1, dtype=torch.int32), max=D,
                out=state.dlq_fill)


def _purge(state: EngineState, sid: int, tenant: int, reason: int,
           stat: str) -> None:
    """Drop every queued SU of ``sid``: counted in ``stat`` and
    ``purged``, dead-lettered as ``reason``, its queue slots freed."""
    hit = state.q_valid & (state.q_sid == sid)
    n = hit.sum(-1, dtype=torch.int32)
    state.stats[stat].add_(n)
    # purged SUs left the queue without being served: the conservation
    # counter pairing "queued_in" (see engine.STAT_KEYS)
    state.stats["purged"].add_(n)
    _dlq_spill(state, hit, tenant, reason)
    state.q_valid.logical_and_(~hit)


def _host(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x))


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------

def admit_stream(tables: DeviceTables, state: EngineState, row: Tuple,
                 tenant: int, n_channels: int, is_composite: bool,
                 model_backed: bool, priority: int, prog, consts) -> None:
    """Claim a spare table row for a newly admitted stream.  Its
    subscription slots start empty (edges are wired afterwards with
    :func:`admit_subscription`, in the append order of a from-scratch
    ``build_tables``); its state slice is reset, so a readmission of a
    recycled sid never sees its predecessor's values."""
    _clear_row(tables, row)
    tables.active[row] = True
    tables.tenant[row] = int(tenant)
    tables.n_channels[row] = int(n_channels)
    tables.is_composite[row] = bool(is_composite)
    tables.model_backed[row] = bool(model_backed)
    tables.priority[row] = int(priority)
    tables.progs[row].copy_(_host(prog))
    tables.consts[row].copy_(_host(consts))
    _reset_state_row(state, row)


def revoke_stream(tables: DeviceTables, state: EngineState, row: Tuple,
                  sid: int) -> None:
    """Remove a stream: clear its row, sever every edge referencing
    ``sid`` (subscribers keep running on their remaining inputs), and
    purge its queued SUs into ``stats["dropped_revoked"]`` and the
    dead-letter spool (reason ``revoked``), so in-flight work drops
    cleanly instead of firing into a recycled row."""
    t_rev = int(tables.tenant[row])     # owner, read before the row clears
    for tbl, cnt in ((tables.in_table, tables.in_count),
                     (tables.out_table, tables.out_count)):
        tbl.masked_fill_(tbl == sid, -1)
        cnt.copy_((tbl >= 0).sum(-1))
    _clear_row(tables, row)
    _purge(state, sid, t_rev, DLQ_REVOKED, "dropped_revoked")
    _reset_state_row(state, row)


def admit_subscription(tables: DeviceTables, target_row: Tuple,
                       src_row: Tuple, target_sid: int, src_sid: int) -> bool:
    """Append one subscription edge ``src -> target``: ``src_sid`` into
    the target's first free in-table slot, ``target_sid`` into the
    source's first free fan-out slot (skipped when already present — the
    out side is deduplicated, as in ``build_tables``).  Returns ``ok``:
    False, and no edit, when either side is out of slots or a row is
    inactive."""
    in_row = tables.in_table[target_row]                       # (M,) view
    out_row = tables.out_table[src_row]                        # (F,) view
    in_free = (in_row < 0).nonzero()[:, 0].tolist()
    out_free = (out_row < 0).nonzero()[:, 0].tolist()
    dup_out = bool((out_row == target_sid).any())
    ok = (bool(in_free) and (dup_out or bool(out_free))
          and bool(tables.active[target_row]) and bool(tables.active[src_row]))
    if ok:
        in_row[in_free[0]] = int(src_sid)
        tables.in_count[target_row] += 1
        if not dup_out:
            out_row[out_free[0]] = int(target_sid)
            tables.out_count[src_row] += 1
    return ok


def revoke_subscription(tables: DeviceTables, target_row: Tuple,
                        src_row: Tuple, target_sid: int, src_sid: int
                        ) -> bool:
    """Remove one occurrence of the edge ``src -> target``; the source's
    fan-out entry is dropped only when no occurrence remains (duplicate
    inputs are legal).  Returns whether an occurrence was removed."""
    in_row = tables.in_table[target_row]
    match = (in_row == src_sid).nonzero()[:, 0].tolist()
    if not match:
        return False
    in_row[match[0]] = -1
    tables.in_count[target_row] -= 1
    if len(match) == 1:             # no occurrence remains
        out_row = tables.out_table[src_row]
        hit = out_row == target_sid
        if bool(hit.any()):
            out_row.masked_fill_(hit, -1)
            tables.out_count[src_row] -= 1
    return True


def swap_program(tables: DeviceTables, row: Tuple, prog, consts) -> None:
    """Replace a composite stream's VM bytecode + constant pool in place —
    user-code injection (paper §IV-F) as a table edit."""
    tables.progs[row].copy_(_host(prog))
    tables.consts[row].copy_(_host(consts))


def migrate_row(tables: DeviceTables, state: EngineState, src_row: Tuple,
                dst_row: Tuple) -> None:
    """Move one stream's table row and state slice to another physical
    slot (cross-shard under the sharded layout), leaving the source slot
    vacated.  The queue is untouched: callers drain before migrating."""
    for obj, fills in ((tables, _TABLE_FILL), (state, _STATE_FILL)):
        for f, fill in fills.items():
            arr = getattr(obj, f)
            arr[dst_row] = arr[src_row].clone()
            arr[src_row] = fill


def set_weight(tables: DeviceTables, tid: int, weight: int) -> None:
    """Set tenant ``tid``'s fair-share weight, clipped to ``[0,
    FAIR_SCALE]`` (0 = unshaped), in every shard's copy."""
    tables.weight[..., tid] = int(np.clip(weight, 0, FAIR_SCALE))


def set_quota(tables: DeviceTables, state: EngineState, tid: int,
              quota: int, burst: int) -> None:
    """Set tenant ``tid``'s ingest token bucket: ``quota`` tokens per
    round up to ``burst``, both clipped to ``[0, QUOTA_MAX]`` (so the
    refill ``tokens + quota`` cannot overflow int32; ``quota=0`` removes
    the cap).  The tenant's current bucket is clamped to the new burst."""
    tables.quota[..., tid] = int(np.clip(quota, 0, QUOTA_MAX))
    tables.burst[..., tid] = int(np.clip(burst, 0, QUOTA_MAX))
    torch.minimum(state.tokens, tables.burst, out=state.tokens)


def quarantine_stream(tables: DeviceTables, state: EngineState, row: Tuple,
                      sid: int) -> None:
    """Quarantine stream ``sid``: flip its ``quarantined`` bit and purge
    its queued SUs into ``stats["dropped_poisoned"]`` and the dead-letter
    spool (reason ``poisoned``) — the breaker's trip action, host
    triggered.  Registration, program and edges stay, so
    :func:`unquarantine_stream` restores service.  Idempotent."""
    _purge(state, sid, int(tables.tenant[row]), DLQ_POISONED,
           "dropped_poisoned")
    state.quarantined[row] = True


def unquarantine_stream(state: EngineState, row: Tuple) -> None:
    """Lift a quarantine: clear the bit and reset the breaker window
    (``fault_count``/``fault_epoch``); the lifetime ``fault_total``
    survives as the supervisor's blame signal."""
    state.quarantined[row] = False
    state.fault_count[row] = 0
    state.fault_epoch[row] = 0


def set_breaker(tables: DeviceTables, vals) -> None:
    """Overwrite the breaker knobs ``[window, threshold, amp_ceiling]`` in
    every shard's copy."""
    tables.breaker.copy_(_host(np.asarray(vals, np.int32)))


def _shard_view(state: EngineState, shard: int) -> EngineState:
    """Shard ``shard``'s slice of a sharded state, as views."""
    return EngineState(*(
        {k: v[shard] for k, v in x.items()} if isinstance(x, dict)
        else x[shard] for x in state))


def _write_back(state: EngineState, new: EngineState) -> None:
    """Copy every leaf of ``new`` that is not ``state``'s own tensor into
    ``state``'s tensor, in place (the stats dict is left to the caller)."""
    for f in EngineState._fields:
        if f != "stats" and getattr(new, f) is not getattr(state, f):
            getattr(state, f).copy_(getattr(new, f))


def _requeue_body(loc: EngineState, sid, vals, ts, valid, tenant,
                  its) -> None:
    """Shared body of :func:`requeue` / :func:`requeue_shard` on one
    (shard's) state."""
    new, dropped = _enqueue(loc, sid, vals, ts, valid, tenant, its=its)
    _write_back(loc, new)
    n = valid.sum(dtype=I32) - dropped
    loc.stats["dropped_overflow"].add_(dropped)
    loc.stats["replayed"].add_(n)
    loc.stats["queued_in"].add_(n)


def requeue(state: EngineState, sid, vals, ts, valid, tenant, its=None
            ) -> None:
    """Enqueue SUs *directly* into the pending queue — the durability
    plane's replay / dead-letter-redelivery edit.  Bypasses phase 0 (and
    its monotone-timestamp gate), so retained historical SUs enter even
    though the stream has since emitted newer data; downstream, Listing-2
    consistency still discards them at subscribers that already processed
    them.  Queue overflow drops are counted, charged to ``tenant`` and
    dead-lettered like any enqueue; SUs that land count in ``replayed``
    and ``queued_in``.  ``its`` carries each SU's original ingest stamp.
    The free-slot search is the staged round's (sorted free slots)."""
    _requeue_body(state, sid, vals, ts, valid, tenant, its)


def requeue_shard(state: EngineState, shard: int, sid, vals, ts, valid,
                  tenant, its=None) -> None:
    """:func:`requeue` into shard ``shard``'s slice of a sharded state; the
    caller routes each item to its owner shard (``q_sid`` holds global
    sids, so the payloads travel unchanged)."""
    _requeue_body(_shard_view(state, shard), sid, vals, ts, valid, tenant,
                  its)


def _respool_body(loc: EngineState, sid, vals, ts, reason, tenant, its,
                  valid) -> None:
    """Shared body of :func:`respool` / :func:`respool_shard`."""
    loc.stats["redeliver_rejected"].add_(valid.sum(dtype=I32))
    _write_back(loc, dlq_append(loc, sid, vals, ts, tenant, reason, valid,
                                its=its))


def respool(state: EngineState, sid, vals, ts, reason, tenant, its,
            valid) -> None:
    """Re-append refused dead letters behind the spool cursor with their
    original per-letter ``reason`` codes and ingest stamps, counting them
    in ``stats["redeliver_rejected"]``: redelivery against revoked or
    quarantined rows leaves the letters *in the spool*.  Saturates like
    any DLQ append (letters past the spool are lost but counted)."""
    _respool_body(state, sid, vals, ts, reason, tenant, its, valid)


def respool_shard(state: EngineState, shard: int, sid, vals, ts, reason,
                  tenant, its, valid) -> None:
    """:func:`respool` into shard ``shard``'s spool of a sharded state."""
    _respool_body(_shard_view(state, shard), sid, vals, ts, reason, tenant,
                  its, valid)


def clear_dead_letters(state: EngineState) -> None:
    """Reset the dead-letter spool cursor (every shard's) after a host
    drain; the payloads need no scrub, ``dlq_fill`` gates every read."""
    state.dlq_fill.zero_()


def reset_windows(store, sid):
    """Clear stream ``sid``'s ring buffer (revoke / readmit of a stream
    that feeds a :class:`~repro_torch.core.windows.WindowStore`)."""
    from repro_torch.core.windows import reset_rows
    return reset_rows(store, sid)
