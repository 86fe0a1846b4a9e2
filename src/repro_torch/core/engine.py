"""The static stream-processing topology (paper §IV-B / §IV-F) — the
PyTorch port of the JAX package's single-device engine round.

One round implements the four stages common to every pipeline:

    1. subscriber dispatching   (fan-out via the routing tables)
    2. data fetching            (gather co-input last values — lock-free)
    3. transformation & filtering (bytecode VM + Listing-2 consistency)
    4. store, trigger actions and emit

Tenants' pipelines — routing tables, bytecode, constants — are tensors the
round reads, so creating, rewiring or re-programming a pipeline is a table
edit.  Each round ingests/pops a *batch* of SUs and advances every live SU
by exactly one hop.

The round runs on the tensors' device.  On the card its two hot kernels
are hand-written CUDA (``kernels/round_fuse`` for the default fused path,
``kernels/sched_pop`` for the staged path's pop); everything around them
is plain torch.  Every function here returns new tensors where the JAX
package returned new arrays, except where a docstring says it updates in
place.  Index semantics follow XLA: gathers clamp out-of-range indices,
and a scatter's out-of-range writes (the ``mode="drop"`` sentinel rows)
land in a pad row that is sliced off.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import consistency, program as pvm
from repro_torch.core.config import EngineConfig
from repro_torch.core.registry import CapacityError, EngineTables, Registry
from repro_torch.kernels.round_fuse import ref as rf_ref

INT_MIN = int(np.iinfo(np.int32).min) + 1
INT_MAX = int(np.iinfo(np.int32).max)

# Virtual-time granularity of the weighted-fair pop: a tenant with weight w
# advances its virtual clock by FAIR_SCALE // w per queued SU; weight 0
# exempts the tenant from shaping (its SUs carry tag 0).
FAIR_SCALE = 1 << 15
# Within-tenant ranks saturate here so rank * FAIR_SCALE // weight stays
# inside int32 (kernels/sched_pop/ref.py applies the same clamp).
RANK_LIM = INT_MAX // FAIR_SCALE - 1
# Quota and burst clip here so the per-round refill tokens + quota cannot
# overflow int32.
QUOTA_MAX = (INT_MAX >> 1) - 1

I32, F32, BOOL = torch.int32, torch.float32, torch.bool


class DeviceTables(NamedTuple):
    """Device image of :class:`~repro_torch.core.registry.EngineTables`:
    the per-stream routing/program tables (leading dim ``n_streams``) plus
    the per-tenant QoS tables (leading dim ``n_tenants``) and the breaker
    knobs.  All of it is data to the round; the QoS and breaker knobs are
    edited in place by ``StreamEngine.set_weight``/``set_quota``/
    ``set_breaker``."""
    in_table: torch.Tensor      # (N, max_in) int32 input sids, -1 pad
    in_count: torch.Tensor      # (N,) int32
    out_table: torch.Tensor     # (N, max_out) int32 subscriber sids, -1 pad
    out_count: torch.Tensor     # (N,) int32
    progs: torch.Tensor         # (N, prog_len, 4) int32 VM bytecode
    consts: torch.Tensor        # (N, n_consts) float32 constant pools
    is_composite: torch.Tensor  # (N,) bool
    tenant: torch.Tensor        # (N,) int32 owning tenant id
    priority: torch.Tensor      # (N,) int32, lower = served first (§IV-E)
    n_channels: torch.Tensor    # (N,) int32
    model_backed: torch.Tensor  # (N,) bool — serviced by the model plane
    active: torch.Tensor        # (N,) live-row mask
    weight: torch.Tensor        # (T,) int32 fair-share weight; 0 = unshaped
    quota: torch.Tensor         # (T,) int32 tokens refilled/round; 0 = no cap
    burst: torch.Tensor         # (T,) int32 token-bucket capacity
    breaker: torch.Tensor       # (3,) int32 [window W, threshold F, amp ceil]

    @classmethod
    def from_host(cls, t: EngineTables, device) -> "DeviceTables":
        """Move every host (numpy) table of ``t`` onto ``device``
        unchanged in shape and dtype."""
        return cls(**{f: _tensor(getattr(t, f), device) for f in cls._fields})


class EngineState(NamedTuple):
    """The mutable half of one engine: last values, the pending-SU queue,
    the durability leaves, the fault plane and the counters (same fields,
    shapes and dtypes as the JAX package's ``EngineState``)."""
    values: torch.Tensor        # (N, C) last value per stream
    timestamps: torch.Tensor    # (N,) int32 last emission ts (INT_MIN = never)
    q_sid: torch.Tensor         # (Q,)
    q_vals: torch.Tensor        # (Q, C)
    q_ts: torch.Tensor          # (Q,)
    q_its: torch.Tensor         # (Q,) ingest stamp (round of first ingest)
    q_seq: torch.Tensor         # (Q,) FIFO tiebreaker
    q_valid: torch.Tensor       # (Q,) bool
    seq: torch.Tensor           # scalar int32
    tenant_emitted: torch.Tensor  # (T,) emissions per owning tenant
    tokens: torch.Tensor        # (T,) ingest token buckets (quota plane)
    tenant_queued: torch.Tensor   # (T,) queue occupancy after the round
    tenant_dropped_quota: torch.Tensor     # (T,) SUs shed over quota
    tenant_dropped_overflow: torch.Tensor  # (T,) queue drops
    ret_vals: torch.Tensor      # (N, Rr, C) per-stream retained emissions
    ret_ts: torch.Tensor        # (N, Rr) their timestamps
    ret_its: torch.Tensor       # (N, Rr) their ingest stamps
    ret_count: torch.Tensor     # (N,) emissions ever retained (ring cursor)
    dlq_sid: torch.Tensor       # (D,) dead-letter stream ids
    dlq_vals: torch.Tensor      # (D, C) dead-letter payloads
    dlq_ts: torch.Tensor        # (D,) dead-letter timestamps
    dlq_its: torch.Tensor       # (D,) dead-letter ingest stamps
    dlq_reason: torch.Tensor    # (D,) drop class (see DLQ_REASONS)
    dlq_tenant: torch.Tensor    # (D,) charged tenant
    dlq_fill: torch.Tensor      # scalar int32 spool cursor
    quarantined: torch.Tensor   # (N,) bool — breaker-tripped rows
    fault_count: torch.Tensor   # (N,) int32 faults inside the current window
    fault_epoch: torch.Tensor   # (N,) int32 round the current window opened
    fault_total: torch.Tensor   # (N,) int32 lifetime faults
    round_idx: torch.Tensor     # scalar int32 device round counter
    stats: Dict[str, torch.Tensor]


class IngestBatch(NamedTuple):
    """One round's external Sensor Updates, padded to ``cfg.batch`` rows
    (``valid`` masks the live ones)."""
    sid: torch.Tensor           # (B,) int32
    vals: torch.Tensor          # (B, C) float32
    ts: torch.Tensor            # (B,) int32 event timestamps
    valid: torch.Tensor         # (B,) bool
    its: torch.Tensor           # (B,) int32 ingest stamps


class SinkBatch(NamedTuple):
    """Per-round external emissions: the first ``sink_buffer`` winners."""
    sid: torch.Tensor           # (S,)
    vals: torch.Tensor          # (S, C)
    ts: torch.Tensor            # (S,)
    valid: torch.Tensor         # (S,) bool
    its: torch.Tensor           # (S,) int32 ingest stamps


class DeadLetter(NamedTuple):
    """One recovered drop, drained by ``StreamEngine.dead_letters()``."""
    sid: int
    vals: np.ndarray
    ts: int
    reason: str
    tenant: int
    its: int = 0


STAT_KEYS = (
    "ingested", "ingest_stale", "ingest_coalesced",
    "processed", "discarded_stale", "filtered", "coalesced",
    "emitted", "enqueued", "dropped_overflow", "nonfinite",
    "dropped_revoked", "dropped_spool", "dropped_quota",
    "replayed",
    # queue-flow conservation: queued_in == popped + purged + occupancy
    "queued_in", "popped", "purged",
    "dropped_poisoned", "redeliver_rejected",
)

# Dead-letter drop classes: every ``dropped_*`` stat has a DLQ reason code.
DLQ_OVERFLOW, DLQ_REVOKED, DLQ_SPOOL, DLQ_QUOTA, DLQ_POISONED = range(5)
DLQ_REASONS = ("overflow", "revoked", "spool", "quota", "poisoned")


# --------------------------------------------------------------------------
# tensor helpers: XLA's gather/scatter index semantics
# --------------------------------------------------------------------------

def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own: on the CPU ``.numpy()`` would
    share the tensor's storage, which in-place edits change later."""
    return t.detach().to("cpu", copy=True).numpy()


def _tensor(a, device) -> torch.Tensor:
    """A host array as a tensor of the same dtype on ``device`` (copied, so
    read-only numpy views are fine)."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def _cumsum(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.to(I32), 0, dtype=I32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 with XLA's gather rule: a negative index
    wraps once, then the index clamps into range."""
    return x[pvm.read_index(idx, x.shape[0])]


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _padded(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _src(t: torch.Tensor, src) -> torch.Tensor:
    """A scalar ``src`` as a 0-dim tensor filled on ``t``'s device (never a
    tensor made from host data, which is a synchronising copy on the
    card)."""
    return src if isinstance(src, torch.Tensor) else t.new_full((), src)


def _set_drop(t: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``t.at[idx].set(src, mode="drop")``: rows ``idx`` outside
    ``[0, len(t))`` are dropped (written to a pad row, then sliced off).
    In-range indices must be unique."""
    n = t.shape[0]
    pad = _padded(t)
    pad[_drop_index(idx, n)] = _src(t, src)
    return pad[:n]


def _set_drop2(t: torch.Tensor, i: torch.Tensor, j: torch.Tensor, src
               ) -> torch.Tensor:
    """``t.at[i, j].set(src, mode="drop")`` for rows ``i`` (dropped when
    out of range) and in-range columns ``j``."""
    n = t.shape[0]
    pad = _padded(t)
    pad[_drop_index(i, n), j.long()] = _src(t, src)
    return pad[:n]


def _add_drop(t: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``t.at[idx].add(val, mode="drop")`` on a 1-D integer tensor;
    repeated indices accumulate."""
    n = t.shape[0]
    idx = _drop_index(idx, n)
    src = torch.broadcast_to(_src(t, val), idx.shape)
    return _padded(t).index_add_(0, idx, src)[:n]


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is primary, ties keep index
    order (stable sorts from the least significant key up)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------

def init_state(cfg: EngineConfig, device) -> EngineState:
    """Fresh all-zero :class:`EngineState` on ``device`` (timestamps at
    ``INT_MIN`` = never emitted, empty queue, zero counters)."""
    N, C, Q, T = cfg.n_streams, cfg.channels, cfg.queue, cfg.n_tenants
    Rr, D = cfg.retention_slots, cfg.dlq_slots

    def z(shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EngineState(
        values=z((N, C), F32),
        timestamps=torch.full((N,), INT_MIN, dtype=I32, device=device),
        q_sid=z((Q,)), q_vals=z((Q, C), F32), q_ts=z((Q,)), q_its=z((Q,)),
        q_seq=z((Q,)), q_valid=z((Q,), BOOL), seq=z(()),
        tenant_emitted=z((T,)), tokens=z((T,)), tenant_queued=z((T,)),
        tenant_dropped_quota=z((T,)), tenant_dropped_overflow=z((T,)),
        ret_vals=z((N, Rr, C), F32), ret_ts=z((N, Rr)), ret_its=z((N, Rr)),
        ret_count=z((N,)),
        dlq_sid=z((D,)), dlq_vals=z((D, C), F32), dlq_ts=z((D,)),
        dlq_its=z((D,)), dlq_reason=z((D,)), dlq_tenant=z((D,)),
        dlq_fill=z(()),
        quarantined=z((N,), BOOL), fault_count=z((N,)), fault_epoch=z((N,)),
        fault_total=z((N,)), round_idx=z(()),
        stats={k: z(()) for k in STAT_KEYS},
    )


def dlq_append(state: EngineState, sid, vals, ts, tenant, reason, mask,
               its=None) -> EngineState:
    """Spill the masked dropped SUs into the dead-letter spool behind
    ``dlq_fill``; letters beyond ``cfg.dlq_slots`` are lost (the
    ``dropped_*`` stats still count them), and with ``dlq_slots == 0``
    this is a no-op.  ``reason`` is one ``DLQ_*`` code or a tensor of one
    per item; ``tenant=None`` records the sentinel ``-1``; ``its=None``
    records stamp 0."""
    D = state.dlq_sid.shape[0]
    if D == 0:
        return state
    if tenant is None:
        tenant = torch.full_like(sid, -1)
    if its is None:
        its = torch.zeros_like(sid)
    rank = state.dlq_fill + _cumsum(mask) - 1
    dest = torch.where(mask & (rank < D), rank, D)
    return state._replace(
        dlq_sid=_set_drop(state.dlq_sid, dest, sid),
        dlq_vals=_set_drop(state.dlq_vals, dest, vals),
        dlq_ts=_set_drop(state.dlq_ts, dest, ts),
        dlq_its=_set_drop(state.dlq_its, dest, its),
        dlq_reason=_set_drop(state.dlq_reason, dest, reason),
        dlq_tenant=_set_drop(state.dlq_tenant, dest, tenant),
        dlq_fill=torch.clamp(state.dlq_fill + _count(mask), max=D),
    )


# --------------------------------------------------------------------------
# queue helpers
# --------------------------------------------------------------------------

def _first_free(q_valid: torch.Tensor, X: int, fast: bool = False
                ) -> torch.Tensor:
    """Indices of the first ``X`` free queue slots, ascending, padded with
    ``Q`` (int32).  ``fast=True`` (the fused round) is the cumsum +
    searchsorted search of :mod:`repro_torch.kernels.round_fuse.ref`; the
    staged round sorts the free-slot indices (the one torch form of both
    the X-step selection loop and the ``nonzero`` scatter the JAX package
    switches between by width — same result)."""
    if fast:
        return rf_ref.first_free_slots(q_valid, X)
    Q = q_valid.shape[0]
    iota = torch.arange(Q, dtype=I32, device=q_valid.device)
    free = torch.sort(torch.where(~q_valid, iota, Q)).values[:X]
    if X > Q:
        free = torch.cat([free, free.new_full((X - Q,), Q)])
    return free


def _enqueue(state: EngineState, sid, vals, ts, mask, tenant=None,
             fast_free: bool = False, its=None
             ) -> Tuple[EngineState, torch.Tensor]:
    """Append masked items into free queue slots; returns ``(state,
    #dropped)``.  With ``tenant`` (an (X,) tenant id per item, negative =
    unknown owner) overflow drops are charged per tenant.  Sequence
    numbers advance on accept only."""
    Q = state.q_valid.shape[0]
    X = sid.shape[0]
    if its is None:
        its = torch.zeros_like(sid)
    free = _first_free(state.q_valid, X, fast_free)
    rank = _cumsum(mask) - 1
    dest = torch.where(mask, free[torch.clamp(rank, 0, X - 1).long()], Q)
    ok = mask & (dest < Q)
    dest = torch.where(ok, dest, Q)
    seq_nos = state.seq + _cumsum(ok)
    new = state._replace(
        q_sid=_set_drop(state.q_sid, dest, sid),
        q_vals=_set_drop(state.q_vals, dest, vals),
        q_ts=_set_drop(state.q_ts, dest, ts),
        q_its=_set_drop(state.q_its, dest, its),
        q_seq=_set_drop(state.q_seq, dest, seq_nos),
        q_valid=_set_drop(state.q_valid, dest, True),
        seq=state.seq + _count(ok),
    )
    drop_mask = mask & ~ok
    if tenant is not None:
        T = state.tenant_dropped_overflow.shape[0]
        new = new._replace(tenant_dropped_overflow=_add_drop(
            new.tenant_dropped_overflow,
            torch.where(drop_mask & (tenant >= 0), tenant, T), 1))
    new = dlq_append(new, sid, vals, ts, tenant, DLQ_OVERFLOW, drop_mask,
                     its=its)
    return new, _count(drop_mask)


def _tenant_rank(mask: torch.Tensor, tenant_idx: torch.Tensor,
                 n_tenants: int) -> torch.Tensor:
    """0-based rank of each masked item among masked items of the same
    tenant, in array order (unmasked lanes read an arbitrary value)."""
    t = tenant_idx.long()
    onehot = mask[:, None] & (
        t[:, None] == torch.arange(n_tenants, device=t.device)[None, :])
    ranks = torch.cumsum(onehot.to(I32), 0, dtype=I32) - 1
    return ranks.gather(1, pvm.read_index(t, n_tenants)[:, None])[:, 0]


def _pop(state: EngineState, priority_by_sid: torch.Tensor, batch: int,
         tenant_by_sid: Optional[torch.Tensor] = None,
         weight: Optional[torch.Tensor] = None,
         scheduler: str = "packed", use_kernel: Optional[bool] = None):
    """Pop up to ``batch`` queued SUs, lowest ``(priority, virtual fair
    tag, seq)`` first — the §IV-E priority pop composed with weighted-fair
    queueing across tenants (see the JAX package's ``_pop``).

    ``"packed"`` is the selection pop of :mod:`repro_torch.kernels.sched_pop`
    (the CUDA kernel on the card); ``"lexsort"`` the two-full-sort oracle.
    Both return the same slots.  Returns ``(state, (sid, vals, ts, its,
    valid))``."""
    if scheduler == "packed":
        from repro_torch.kernels.sched_pop.ops import sched_pop
        prio_slot = _take(priority_by_sid, state.q_sid)
        if tenant_by_sid is None:
            t_slot = torch.zeros_like(state.q_sid)
            w_slot = torch.zeros_like(state.q_sid)
        else:
            T = weight.shape[0]
            t_slot = torch.clamp(_take(tenant_by_sid, state.q_sid), 0, T - 1)
            w_slot = weight[t_slot.long()]
        take, popped = sched_pop(prio_slot, state.q_seq, state.q_valid,
                                 t_slot, w_slot, state.q_sid, state.q_vals,
                                 state.q_ts, batch, use_kernel=use_kernel)
        p_sid, p_vals, p_ts, p_valid = popped
        t = take.long()
        q_valid = state.q_valid.index_fill(0, t, False)
        return state._replace(q_valid=q_valid), \
            (p_sid, p_vals, p_ts, state.q_its[t], p_valid)
    key = torch.where(state.q_valid, _take(priority_by_sid, state.q_sid),
                      INT_MAX)
    if tenant_by_sid is None:
        order = _lexsort(state.q_seq, key)
    else:
        T = weight.shape[0]
        order0 = _lexsort(state.q_seq, key)        # (priority, seq) order
        t_sort = torch.clamp(_take(tenant_by_sid, state.q_sid), 0,
                             T - 1)[order0]
        v_sort = state.q_valid[order0]
        rank = _tenant_rank(v_sort, t_sort, T)     # within-tenant rank
        w = weight[t_sort.long()]
        rank = torch.clamp(rank, max=RANK_LIM)     # int32-safe tags
        vtag = torch.where(v_sort & (w > 0),
                           rank * FAIR_SCALE // torch.clamp(w, min=1), 0)
        reorder = _lexsort(state.q_seq[order0], vtag, key[order0])
        order = order0[reorder]
    take = order[:batch]
    popped = (state.q_sid[take], state.q_vals[take], state.q_ts[take],
              state.q_its[take], state.q_valid[take])
    return state._replace(q_valid=state.q_valid.index_fill(0, take, False)
                          ), popped


# --------------------------------------------------------------------------
# phase 0 / stage 4
# --------------------------------------------------------------------------

def _inc(stats: Dict[str, torch.Tensor], key: str, v: torch.Tensor) -> None:
    stats[key] = stats[key] + v


def ingest_phase(state: EngineState, stats: Dict[str, torch.Tensor],
                 ingest: IngestBatch, row, q_sid, active, n_rows: int,
                 tenant_of_row=None, quota=None, burst=None,
                 fast_free: bool = False, quarantined=None
                 ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
    """Phase 0: admit external SUs — quota gate, store last value and
    timestamp, enqueue for dispatch.  SUs addressed to revoked rows drop
    into ``dropped_revoked``, to quarantined rows into
    ``dropped_poisoned`` (both dead-lettered).  With the QoS args each
    tenant's token bucket refills by ``quota[t]`` per round up to
    ``burst[t]``; arrivals beyond it are shed into ``dropped_quota``.
    ``stats`` is updated in place (its tensors are replaced)."""
    if quarantined is None:
        quarantined = torch.zeros_like(active)
    arrive = ingest.valid & active & ~quarantined
    if tenant_of_row is None:
        i_live = arrive
    else:
        T = quota.shape[0]
        t_of = torch.clamp(tenant_of_row, 0, T - 1)
        tokens = torch.minimum(state.tokens + quota, burst)
        arrival_no = _tenant_rank(arrive, t_of, T)
        in_quota = (quota[t_of.long()] == 0) | (arrival_no < tokens[t_of.long()])
        shed = arrive & ~in_quota
        i_live = arrive & in_quota
        spent = torch.zeros((T,), dtype=I32, device=t_of.device).index_add_(
            0, t_of.long(), (arrive & in_quota).to(I32))
        state = state._replace(
            tokens=torch.where(quota > 0, tokens - spent, tokens),
            tenant_dropped_quota=_add_drop(
                state.tenant_dropped_quota, torch.where(shed, t_of, T), 1))
        _inc(stats, "dropped_quota", _count(shed))
        state = dlq_append(state, q_sid, ingest.vals, ingest.ts, t_of,
                           DLQ_QUOTA, shed, its=ingest.its)
    i_keep = i_live & (ingest.ts > _take(state.timestamps, row))
    i_win = consistency.resolve_winners(row, ingest.ts, i_keep, n_rows)
    i_dest = torch.where(i_win, row, n_rows)
    state = state._replace(
        values=_set_drop(state.values, i_dest, ingest.vals),
        timestamps=_set_drop(state.timestamps, i_dest, ingest.ts),
    )
    Rr = state.ret_ts.shape[-1]
    if Rr:                          # a source's stored SU is its emission
        slot = _take(state.ret_count, row) % Rr
        state = state._replace(
            ret_vals=_set_drop2(state.ret_vals, i_dest, slot, ingest.vals),
            ret_ts=_set_drop2(state.ret_ts, i_dest, slot, ingest.ts),
            ret_its=_set_drop2(state.ret_its, i_dest, slot, ingest.its),
            ret_count=_add_drop(state.ret_count, i_dest, 1))
    revoked = ingest.valid & ~active
    _inc(stats, "ingested", _count(ingest.valid))
    _inc(stats, "dropped_revoked", _count(revoked))
    state = dlq_append(state, q_sid, ingest.vals, ingest.ts, tenant_of_row,
                       DLQ_REVOKED, revoked, its=ingest.its)
    i_poison = ingest.valid & active & quarantined
    _inc(stats, "dropped_poisoned", _count(i_poison))
    state = dlq_append(state, q_sid, ingest.vals, ingest.ts, tenant_of_row,
                       DLQ_POISONED, i_poison, its=ingest.its)
    _inc(stats, "ingest_stale", _count(i_live & ~i_keep))
    _inc(stats, "ingest_coalesced", _count(i_keep & ~i_win))
    state, dropped = _enqueue(state, q_sid, ingest.vals, ingest.ts, i_win,
                              tenant_of_row, fast_free, its=ingest.its)
    _inc(stats, "dropped_overflow", dropped)
    _inc(stats, "queued_in", _count(i_win) - dropped)
    return state, stats


def store_and_emit(cfg: EngineConfig, tables: DeviceTables,
                   state: EngineState, stats: Dict[str, torch.Tensor],
                   rows, emit_sid, order, new_vals, ts_out, keep,
                   n_rows: int, fast_free: bool = False, wi_its=None
                   ) -> Tuple[EngineState, Dict[str, torch.Tensor], SinkBatch]:
    """Stage 4: coalesce winners, store them, account per-tenant
    emissions, re-enqueue winners that have subscribers, and fill the
    external sink buffer.  ``rows`` (W,) are in-range target rows,
    ``order`` the coalescing tie key (the trigger sid)."""
    S, C = cfg.sink_buffer, cfg.channels
    if wi_its is None:
        wi_its = torch.zeros_like(emit_sid)
    win = consistency.resolve_winners(rows, ts_out, keep, n_rows, order=order)
    _inc(stats, "coalesced", _count(keep & ~win))
    _inc(stats, "emitted", _count(win))
    dest = torch.where(win, rows, n_rows)
    owner = _take(tables.tenant, rows)
    state = state._replace(
        values=_set_drop(state.values, dest, new_vals),
        timestamps=_set_drop(state.timestamps, dest, ts_out),
        tenant_emitted=_add_drop(state.tenant_emitted,
                                 torch.where(win, owner, cfg.n_tenants), 1),
    )
    Rr = cfg.retention_slots
    if Rr:
        slot = _take(state.ret_count, rows) % Rr
        state = state._replace(
            ret_vals=_set_drop2(state.ret_vals, dest, slot, new_vals),
            ret_ts=_set_drop2(state.ret_ts, dest, slot, ts_out),
            ret_its=_set_drop2(state.ret_its, dest, slot, wi_its),
            ret_count=_add_drop(state.ret_count, dest, 1),
        )
    # re-dispatch winners that themselves have subscribers (queue drops
    # charged to the emitting stream's owner tenant)
    fanout_more = win & (_take(tables.out_count, rows) > 0)
    state, dropped = _enqueue(state, emit_sid, new_vals, ts_out, fanout_more,
                              owner, fast_free, its=wi_its)
    _inc(stats, "dropped_overflow", dropped)
    _inc(stats, "enqueued", _count(fanout_more))
    _inc(stats, "queued_in", _count(fanout_more) - dropped)

    # external sink buffer: first `sink_buffer` winners this round
    sink_rank = _cumsum(win) - 1
    sdest = torch.where(win & (sink_rank < S), sink_rank, S)
    dev = rows.device
    sink = SinkBatch(
        sid=_set_drop(torch.zeros((S,), dtype=I32, device=dev), sdest,
                      emit_sid),
        vals=_set_drop(torch.zeros((S, C), dtype=F32, device=dev), sdest,
                       new_vals),
        ts=_set_drop(torch.zeros((S,), dtype=I32, device=dev), sdest, ts_out),
        valid=_set_drop(torch.zeros((S,), dtype=BOOL, device=dev), sdest,
                        True),
        its=_set_drop(torch.zeros((S,), dtype=I32, device=dev), sdest,
                      wi_its),
    )
    return state, stats, sink


def tenant_occupancy(state: EngineState, tenant_by_sid: torch.Tensor,
                     n_tenants: int) -> torch.Tensor:
    """Per-tenant pending-SU queue occupancy (the backpressure signal)."""
    q_t = torch.clamp(_take(tenant_by_sid, state.q_sid), 0, n_tenants - 1)
    onehot = (q_t[:, None] == torch.arange(n_tenants, device=q_t.device)
              [None, :]) & state.q_valid[:, None]
    return onehot.sum(dim=0, dtype=I32)


# --------------------------------------------------------------------------
# fault-isolation plane
# --------------------------------------------------------------------------

def fault_events(breaker, badf, wi_valid, t_row, fan, e_valid, e_row,
                 n_rows: int) -> torch.Tensor:
    """One round's per-row fault mask: non-finite program results charged
    to the target row, and fan-outs over ``breaker[2]`` charged to the
    source row (ceiling 0 disables that class).  Any-reductions: a row
    faults at most once per round."""
    dev = badf.device
    nf_row = _set_drop(torch.zeros((n_rows,), dtype=BOOL, device=dev),
                       torch.where(badf & wi_valid, t_row, n_rows), True)
    amp = (breaker[2] > 0) & e_valid & (fan > breaker[2])
    amp_row = _set_drop(torch.zeros((n_rows,), dtype=BOOL, device=dev),
                        torch.where(amp, e_row, n_rows), True)
    return nf_row | amp_row


def fault_phase(state: EngineState, stats: Dict[str, torch.Tensor],
                breaker, fault_evt, active, tenant_of_row, q_row
                ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
    """Advance the per-stream circuit breaker one round and quarantine the
    rows that tripped: the first fault opens a W-round window, faults
    inside it count up, a fault after expiry restarts it at 1, a
    fault-free round past expiry decays it to 0; an active,
    not-yet-quarantined row reaching ``F > 0`` trips, and its queued SUs
    purge to the DLQ as ``poisoned`` this same round."""
    W, F = breaker[0], breaker[1]
    rid = state.round_idx
    in_win = (rid - state.fault_epoch) < W
    restart = fault_evt & (~in_win | (state.fault_count == 0))
    count = torch.where(
        fault_evt,
        torch.where(restart, 1, state.fault_count + 1),
        torch.where(in_win, state.fault_count, 0)).to(I32)
    epoch = torch.where(restart, rid, state.fault_epoch)
    trip = (F > 0) & (count >= F) & active & ~state.quarantined
    quarantined = state.quarantined | trip
    state = state._replace(
        quarantined=quarantined, fault_count=count, fault_epoch=epoch,
        fault_total=state.fault_total + fault_evt.to(I32),
        round_idx=rid + 1,
    )
    hit = state.q_valid & quarantined[q_row.long()]
    n_hit = _count(hit)
    _inc(stats, "dropped_poisoned", n_hit)
    _inc(stats, "purged", n_hit)
    state = dlq_append(state, state.q_sid, state.q_vals, state.q_ts,
                       tenant_of_row[q_row.long()], DLQ_POISONED, hit,
                       its=state.q_its)
    return state._replace(q_valid=state.q_valid & ~hit), stats


# --------------------------------------------------------------------------
# stages 1-3 of the staged round
# --------------------------------------------------------------------------

def fanout_reference(sid, ts, pvalid, out_table, timestamps, *,
                     with_early: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stage 1: expand each event to its subscribers.  sid/ts/pvalid:
    (B,); out_table: (n_tab, F) int32 (-1 pad); timestamps: (N,) int32.
    Returns targets (B, F), -1 where there is none or the event is not
    valid, and the early-keep mask (B, F) — ``ts`` newer than the
    target's last emission — or ``None`` in its place with
    ``with_early=False``: the round asks for that, since it applies the
    same check in ``process_work_items``' keep mask.  Any function of
    this signature can be passed to the round builders as ``fanout_fn``
    (e.g. ``kernels.stream_dispatch.ops.make_fanout()``)."""
    targets = _take(out_table, torch.clamp(sid, 0, out_table.shape[0] - 1))
    tvalid = (targets >= 0) & pvalid[:, None]
    out = torch.where(tvalid, targets, -1)
    if not with_early:
        return out, None
    t_safe = torch.clamp(targets, 0, timestamps.shape[0] - 1)
    return out, tvalid & (ts[:, None] > timestamps[t_safe.long()])


def process_work_items(cfg: EngineConfig, tables: DeviceTables, rows, t_sid,
                       wi_src, wi_vals, wi_ts, wi_valid, values_by_sid,
                       timestamps_by_sid):
    """Data fetching + transformation/filtering for a work-item batch (the
    full 29-opcode VM in plain torch).  Returns ``(new_vals, ts_out,
    live, keep, counts, badf)``: counts holds the stage-3 stat increments,
    ``badf`` flags non-finite VM results before ``wi_valid`` masking."""
    layout = rf_ref.RegLayout.from_cfg(cfg)
    regs_out, ts_in, in_valid, prev_ts = rf_ref.fetch_and_run(
        layout, tables.in_table, tables.progs, tables.consts, rows, t_sid,
        wi_src, wi_vals, wi_ts, values_by_sid, timestamps_by_sid)
    new_vals, ts_out, keep_ts, passf, badf = rf_ref.verdict(
        layout, regs_out, wi_ts, prev_ts, ts_in, in_valid)
    r = rows.long()
    live = wi_valid & tables.is_composite[r] & tables.active[r]
    keep = live & keep_ts & passf
    counts = {
        "processed": _count(live),
        "discarded_stale": _count(live & ~keep_ts),
        "filtered": _count(live & keep_ts & ~passf),
        "nonfinite": _count(badf & wi_valid),
    }
    return new_vals, ts_out, live, keep, counts, badf


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def make_step(cfg: EngineConfig, fanout_fn: Callable = fanout_reference,
              fused: Optional[bool] = None,
              use_kernel: Optional[bool] = None) -> Callable:
    """Build the engine round ``step(tables, state, ingest) -> (state,
    sink)``.  ``fused`` (default ``cfg.fused_round``) runs stages 1-3 as
    one :func:`~repro_torch.kernels.round_fuse.ops.fused_stages`
    operation; otherwise the staged pop / ``fanout_fn`` /
    ``process_work_items`` sequence.  Bit-identical for fusable programs;
    the fused pop is the packed scheduler, so ``scheduler="lexsort"``
    always takes the staged path.  ``fanout_fn`` (stage 1, signature of
    :func:`fanout_reference`) runs on the staged path only: the fused
    operation does its own fan-out, as in the JAX package.
    ``use_kernel`` is passed to the kernel wrappers (``None``: follow the
    tensors' device; ``False``: the plain versions on any device, which
    ``chip_smoke.py`` installs on an engine to compare the kernels with
    on the card)."""
    N, F = cfg.n_streams, cfg.max_out
    B, W, T = cfg.batch, cfg.work, cfg.n_tenants
    if fused is None:
        fused = cfg.fused_round
    fused = fused and cfg.scheduler == "packed"

    def ingest(tables, state, batch):
        stats = dict(state.stats)
        i_sid = torch.clamp(batch.sid, 0, N - 1)
        i_row = i_sid.long()
        return ingest_phase(state, stats, batch, i_sid, i_sid,
                            tables.active[i_row], N, tables.tenant[i_row],
                            tables.quota, tables.burst, fast_free=fused,
                            quarantined=state.quarantined[i_row])

    def drop_dead_events(tables, state, stats, e_sid, e_vals, e_ts, e_its,
                         e_pop):
        # events whose stream was revoked/quarantined while queued drop
        # here (split so triage can tell the two apart)
        e_row = torch.clamp(e_sid, 0, N - 1)
        r = e_row.long()
        e_real = tables.active[r]
        e_poison = e_pop & e_real & state.quarantined[r]
        _inc(stats, "dropped_revoked", _count(e_pop & ~e_real))
        state = dlq_append(state, e_sid, e_vals, e_ts, tables.tenant[r],
                           DLQ_REVOKED, e_pop & ~e_real, its=e_its)
        _inc(stats, "dropped_poisoned", _count(e_poison))
        state = dlq_append(state, e_sid, e_vals, e_ts, tables.tenant[r],
                           DLQ_POISONED, e_poison, its=e_its)
        return state, e_row, e_real

    def finish(tables, state, stats, badf, wi_valid, t, wi_t, e_valid,
               e_row):
        fan = (wi_t.reshape(B, F) >= 0).sum(dim=1, dtype=I32)
        fault_evt = fault_events(tables.breaker, badf, wi_valid, t, fan,
                                 e_valid, e_row, N)
        state, stats = fault_phase(state, stats, tables.breaker, fault_evt,
                                   tables.active, tables.tenant,
                                   torch.clamp(state.q_sid, 0, N - 1))
        return state._replace(stats=stats, tenant_queued=tenant_occupancy(
            state, tables.tenant, T))

    if fused:
        from repro_torch.kernels.round_fuse.ops import fused_stages
        layout = rf_ref.RegLayout.from_cfg(cfg)

        def step(tables: DeviceTables, state: EngineState,
                 batch: IngestBatch) -> Tuple[EngineState, SinkBatch]:
            # ---- phase 0: ingest external SUs ---------------------------
            state, stats = ingest(tables, state, batch)
            # ---- stages 1-3 fused: pop, fan-out, fetch+VM, window gate --
            # quarantined rows ride the kernel's active gate; the real
            # mask is re-read outside so revoked and poisoned drops stay
            # separately accounted
            eff_active = tables.active & ~state.quarantined
            prio_slot = _take(tables.priority, state.q_sid)
            t_slot = torch.clamp(_take(tables.tenant, state.q_sid), 0, T - 1)
            w_slot = tables.weight[t_slot.long()]
            take, (e_sid, e_vals, e_ts, e_pop, e_act), wi_t, applied = \
                fused_stages(prio_slot, state.q_seq, state.q_valid, t_slot,
                             w_slot, state.q_sid, state.q_vals, state.q_ts,
                             B, tables.out_table, tables.in_table,
                             tables.progs, tables.consts,
                             tables.is_composite, eff_active,
                             state.values, state.timestamps, layout,
                             use_kernel=use_kernel)
            tk = take.long()
            e_its = state.q_its[tk]
            state = state._replace(
                q_valid=state.q_valid.index_fill(0, tk, False))
            _inc(stats, "popped", _count(e_pop))
            state, e_row, _ = drop_dead_events(tables, state, stats, e_sid,
                                               e_vals, e_ts, e_its, e_pop)
            new_vals, ts_out, live, keep, keep_ts, passf, badf = applied
            wi_valid = wi_t >= 0
            _inc(stats, "processed", _count(live))
            _inc(stats, "discarded_stale", _count(live & ~keep_ts))
            _inc(stats, "filtered", _count(live & keep_ts & ~passf))
            _inc(stats, "nonfinite", _count(badf & wi_valid))
            # ---- stage 4: store, trigger actions and emit ---------------
            t = torch.clamp(wi_t, 0, N - 1)
            wi_src = torch.repeat_interleave(e_sid, F)
            wi_its = torch.repeat_interleave(e_its, F)
            state, stats, sink = store_and_emit(
                cfg, tables, state, stats, t, t, wi_src, new_vals, ts_out,
                keep, N, fast_free=True, wi_its=wi_its)
            # ---- fault plane: breaker window + device auto-quarantine ---
            state = finish(tables, state, stats, badf, wi_valid, t, wi_t,
                           e_pop & e_act, e_row)
            return state, sink

        return step

    def step(tables: DeviceTables, state: EngineState, batch: IngestBatch
             ) -> Tuple[EngineState, SinkBatch]:
        # ---- phase 0: ingest external SUs (quota-gate, store, enqueue) --
        state, stats = ingest(tables, state, batch)
        # ---- pop this round's events (weighted-fair across tenants) -----
        state, (e_sid, e_vals, e_ts, e_its, e_pop) = _pop(
            state, tables.priority, B, tables.tenant, tables.weight,
            cfg.scheduler, use_kernel=use_kernel)
        _inc(stats, "popped", _count(e_pop))
        state, e_row, e_real = drop_dead_events(tables, state, stats, e_sid,
                                                e_vals, e_ts, e_its, e_pop)
        e_valid = e_pop & e_real & ~state.quarantined[e_row.long()]
        # ---- stage 1: subscriber dispatching ----------------------------
        # process_work_items' keep mask applies the stale check, so the
        # fan-out is asked for targets only
        targets, _ = fanout_fn(e_sid, e_ts, e_valid, tables.out_table,
                               state.timestamps, with_early=False)
        wi_t = targets.reshape(W)
        wi_valid = (wi_t >= 0) & torch.repeat_interleave(e_valid, F)
        wi_src = torch.repeat_interleave(e_sid, F)
        wi_vals = torch.repeat_interleave(e_vals, F, dim=0)
        wi_ts = torch.repeat_interleave(e_ts, F)
        wi_its = torch.repeat_interleave(e_its, F)
        t = torch.clamp(wi_t, 0, N - 1)
        # ---- stages 2 + 3: fetch, transform, filter ----------------------
        # the effective active mask (real & ~quarantined) gates the live
        # verdict, exactly the mask the fused kernel sees
        new_vals, ts_out, live, keep, counts, badf = process_work_items(
            cfg, tables._replace(active=tables.active & ~state.quarantined),
            t, t, wi_src, wi_vals, wi_ts, wi_valid,
            state.values, state.timestamps)
        for k, v in counts.items():
            _inc(stats, k, v)
        # ---- stage 4: store, trigger actions and emit ---------------------
        state, stats, sink = store_and_emit(cfg, tables, state, stats,
                                            t, t, wi_src, new_vals, ts_out,
                                            keep, N, wi_its=wi_its)
        # ---- fault plane: breaker window + device auto-quarantine --------
        state = finish(tables, state, stats, badf, wi_valid, t, wi_t,
                       e_valid, e_row)
        return state, sink

    return step


# --------------------------------------------------------------------------
# the superstep execution plane: K rounds per host dispatch
# --------------------------------------------------------------------------

class IngestRing(NamedTuple):
    """Device-resident pool of pending SUs feeding a K-round superstep.

    ``post()`` still appends host-side; at each superstep *boundary* the
    host stages the ring with one edit (:func:`stage_ring`): new SU
    payloads are scattered into free slots and every slot's routing tag is
    rewritten.  Slots tagged ``rnd < K`` form the superstep's ``(K, B)``
    pre-staged ingest grid — round ``rnd`` consumes them at grid column
    ``pos``; slots tagged ``rnd >= K`` are the persistent overflow queue:
    SUs (same-stream bursts longer than K rounds) whose payloads stay
    resident on the device and are merely re-tagged at the next
    boundary."""
    sid: torch.Tensor      # (R,)
    vals: torch.Tensor     # (R, C)
    ts: torch.Tensor       # (R,)
    its: torch.Tensor      # (R,) ingest stamps (latency plane)
    rnd: torch.Tensor      # (R,) target round this superstep; >= K = carried
    pos: torch.Tensor      # (R,) column within the (K, B) grid row
    valid: torch.Tensor    # (R,) bool — slot holds a pending SU


class SinkSpool(NamedTuple):
    """On-device emission spool of one superstep: every round's external
    sink entries appended compactly behind a fill cursor, read back once
    per superstep instead of once per round.  ``rnd`` records the round
    that produced each entry, so per-round :class:`SinkBatch` views can be
    reconstructed bit-identically (``StreamEngine.spool_sinks``).
    Emissions beyond capacity are counted in ``stats["dropped_spool"]`` —
    never silently truncated."""
    sid: torch.Tensor      # (P,)
    vals: torch.Tensor     # (P, C)
    ts: torch.Tensor       # (P,)
    its: torch.Tensor      # (P,) ingest stamps (latency plane)
    rnd: torch.Tensor      # (P,) round within the superstep; the global
    #                        round is engine._last_base + rnd
    fill: torch.Tensor     # scalar int32 cursor


def init_ring(cfg: EngineConfig, K: int, device) -> IngestRing:
    """Empty K-round ingest ring on ``device``: ``cfg.ring_slots(K)`` free
    slots, every tag at ``rnd == K`` (carried / unused)."""
    R, C = cfg.ring_slots(K), cfg.channels

    def z(shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return IngestRing(sid=z((R,)), vals=z((R, C), F32), ts=z((R,)),
                      its=z((R,)),
                      rnd=torch.full((R,), K, dtype=I32, device=device),
                      pos=z((R,)), valid=z((R,), BOOL))


def _init_spool(P: int, C: int, device) -> SinkSpool:
    def z(shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SinkSpool(sid=z((P,)), vals=z((P, C), F32), ts=z((P,)),
                     its=z((P,)), rnd=z((P,)), fill=z(()))


def stage_ring(ring: IngestRing, w_slot, w_sid, w_vals, w_ts, w_its,
               rnd, pos, valid) -> IngestRing:
    """The one host->device edit per superstep boundary: scatter newly
    posted SU payloads into free ring slots (``w_*`` are (R,)-padded;
    ``w_slot == R`` entries drop) and rewrite every slot's routing tag.
    Carried-over slots keep their payloads — only tags travel again.  The
    arguments are device tensors (the host ships them in two copies)."""
    return IngestRing(
        sid=_set_drop(ring.sid, w_slot, w_sid),
        vals=_set_drop(ring.vals, w_slot, w_vals),
        ts=_set_drop(ring.ts, w_slot, w_ts),
        its=_set_drop(ring.its, w_slot, w_its),
        rnd=rnd, pos=pos, valid=valid)


def ring_grid(ring: IngestRing, K: int, B: int, C: int) -> IngestBatch:
    """Materialise the (K, B) pre-staged ingest grid from the ring — each
    staged SU lands at (rnd, pos), exactly where K sequential
    ``_take_ingest`` batches would have put it."""
    use = ring.valid & (ring.rnd < K)
    cell = torch.where(use, ring.rnd * B + ring.pos, K * B)
    dev = ring.sid.device

    def grid(src, shape, dtype):
        return _set_drop(torch.zeros(shape, dtype=dtype, device=dev), cell,
                         src)

    return IngestBatch(
        sid=grid(ring.sid, (K * B,), I32).reshape(K, B),
        vals=grid(ring.vals, (K * B, C), F32).reshape(K, B, C),
        ts=grid(ring.ts, (K * B,), I32).reshape(K, B),
        valid=grid(use, (K * B,), BOOL).reshape(K, B),
        its=grid(ring.its, (K * B,), I32).reshape(K, B))


def spool_append(spool: SinkSpool, sink: SinkBatch, k: int
                 ) -> Tuple[SinkSpool, torch.Tensor]:
    """Append one round's valid sink entries behind the fill cursor;
    returns the spool and the per-entry overflow mask (its sum feeds
    ``dropped_spool``; the mask itself feeds the dead-letter spool)."""
    P = spool.sid.shape[0]
    add = sink.valid
    rank = spool.fill + _cumsum(add) - 1
    dest = torch.where(add & (rank < P), rank, P)
    over = add & (rank >= P)
    return SinkSpool(
        sid=_set_drop(spool.sid, dest, sink.sid),
        vals=_set_drop(spool.vals, dest, sink.vals),
        ts=_set_drop(spool.ts, dest, sink.ts),
        its=_set_drop(spool.its, dest, sink.its),
        rnd=_set_drop(spool.rnd, dest, k),
        fill=torch.clamp(spool.fill + _count(add), max=P),
    ), over


def scan_rounds(round_fn: Callable, state: EngineState, ring: IngestRing,
                K: int, B: int, C: int, P: int,
                tenant_by_sid: Optional[torch.Tensor] = None,
                ) -> Tuple[EngineState, SinkSpool, IngestRing]:
    """The superstep harness: materialise the (K, B) grid from the ring,
    run the round body over it K times spooling each round's sink, and
    invalidate the consumed ring slots.  ``round_fn(state, ingest) ->
    (state, sink)``.  The JAX package's ``lax.scan`` becomes a Python loop
    that only enqueues device work: nothing inside it reads a value back
    to the host.  ``tenant_by_sid`` (indexed by sink sids) attributes
    spool-overflow dead letters to their emitting tenant."""
    grid = ring_grid(ring, K, B, C)
    spool = _init_spool(P, C, ring.sid.device)
    for k in range(K):
        state, sink = round_fn(state, IngestBatch(*(g[k] for g in grid)))
        state, spool = spool_round(state, spool, sink, k, tenant_by_sid)
    return state, spool, ring._replace(valid=ring.valid & (ring.rnd >= K))


def spool_round(state: EngineState, spool: SinkSpool, sink: SinkBatch, k: int,
                tenant_by_sid: Optional[torch.Tensor] = None
                ) -> Tuple[EngineState, SinkSpool]:
    """A superstep's bookkeeping after round ``k``: append the round's
    sink to the spool; entries past its capacity are counted in
    ``dropped_spool`` and dead-lettered (charged through
    ``tenant_by_sid``).  Shared by :func:`scan_rounds` and the sharded
    superstep (once per shard)."""
    spool, over = spool_append(spool, sink, k)
    stats = dict(state.stats)
    _inc(stats, "dropped_spool", _count(over))
    state = state._replace(stats=stats)
    s_ten = None if tenant_by_sid is None else _take(
        tenant_by_sid, torch.clamp(sink.sid, 0, tenant_by_sid.shape[0] - 1))
    state = dlq_append(state, sink.sid, sink.vals, sink.ts, s_ten,
                       DLQ_SPOOL, over, its=sink.its)
    return state, spool


def make_superstep(cfg: EngineConfig, K: int,
                   fanout_fn: Callable = fanout_reference,
                   fused: Optional[bool] = None,
                   use_kernel: Optional[bool] = None) -> Callable:
    """K engine rounds as one call: ``superstep(tables, state, ring) ->
    (state, spool, ring)``.

    The loop body is the exact four-stage round of :func:`make_step`, so
    a K-superstep is bit-identical to K sequential ``round()`` calls; what
    changes is the host boundary: one staged ingest transfer in, one spool
    readback out, and zero device->host round-trips in between.  Tables
    are arguments, so admission edits applied *between* supersteps need
    no new closure."""
    assert K >= 1
    step = make_step(cfg, fanout_fn, fused=fused, use_kernel=use_kernel)
    B, C = cfg.batch, cfg.channels
    P = cfg.spool_slots(K)

    def superstep(tables: DeviceTables, state: EngineState, ring: IngestRing
                  ) -> Tuple[EngineState, SinkSpool, IngestRing]:
        return scan_rounds(lambda st, ing: step(tables, st, ing),
                           state, ring, K, B, C, P, tables.tenant)

    return superstep


# --------------------------------------------------------------------------
# host engine
# --------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA
    raises — the engine never carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the engine's plain torch path on the CPU")
    return dev


class StreamEngine:
    """The single-device engine: owns the tables, the state, the ingest
    ring and the round and superstep closures of both paths.  Runs on
    ``device`` (CUDA by default): the kernels launch for CUDA tensors,
    their plain versions run on the CPU.  ``use_kernel=False`` runs the
    plain versions on the card too (what ``chip_smoke.py`` holds the
    kernels against).  The sharded engine
    (:class:`~repro_torch.distributed.stream_sharding.ShardedStreamEngine`,
    from :func:`create_engine` when ``cfg.n_shards > 1``) overrides the
    layout hooks."""

    def __init__(self, registry: Registry, *, device="cuda",
                 fanout_fn: Callable = fanout_reference,
                 priority: Optional[np.ndarray] = None,
                 use_kernel: Optional[bool] = None):
        self.device = resolve_device(device)
        self.cfg = registry.cfg
        self.registry = registry
        self.use_kernel = use_kernel
        self._fanout_fn = fanout_fn
        # per layout (see _layout_key), per path: (round closure, {K:
        # superstep closure}); kept across resize, so a return to a layout
        # seen before reuses its closures
        self._fn_cache: Dict[Tuple, Dict[str, Tuple[Callable, Dict]]] = {}
        self._init_layout(priority)
        self._pending: List[List] = []  # [sid, vals, ts, ring_slot|None, its]
        self.admission_rejected = 0
        # latency plane: the global round counter stamps each post()ed SU;
        # _last_base is its value just before the latest round()/superstep()
        # — spool round tags offset from it to the global emission round
        self._rounds_done = 0
        self._last_base = 0
        self._steps_done = 0
        self._ring: Optional[IngestRing] = None
        self._ring_K = 0
        self._ring_free: List[int] = []
        self._ckpt = None               # durability plane: see checkpoint_to
        self._refresh_fusable()

    def _init_layout(self, priority: Optional[np.ndarray]) -> None:
        """Lower the registry into device tables and a fresh state (the
        sharded engine adds its plan, lookup maps and slot books)."""
        self.tables = DeviceTables.from_host(
            self.registry.build_tables(priority), self.device)
        self.state = init_state(self.cfg, self.device)
        self._bind_fns()

    def _layout_key(self) -> Tuple:
        """What the round closures are shaped by (the sharded engine adds
        its shard and row counts)."""
        return ("single",)

    def _bind_fns(self) -> None:
        """Point ``_fns`` at the closure cache of the current layout."""
        self._fns = self._fn_cache.setdefault(self._layout_key(), {})

    # -------------------------------------------------------------- ingest
    def post(self, stream, values: Sequence[float], ts: int,
             its: Optional[int] = None) -> None:
        """API ingress: a Web Object posts a Sensor Update (paper §III).
        ``its`` defaults to the engine's round counter (the latency
        plane's ingest stamp)."""
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        v = np.zeros((self.cfg.channels,), np.float32)
        v[: len(values)] = values
        if its is None:
            its = self._rounds_done
        # 4th field: the SU's ingest-ring slot once its payload is shipped
        self._pending.append([sid, v, int(ts), None, int(its)])

    @staticmethod
    def _select_wave(pending: List, B: int) -> Tuple[List, List]:
        """One round's ingest selection: at most one pending SU per
        stream (preserving order), at most B total.  Shared by
        ``_take_ingest`` and the superstep staging, so both paths pack SUs
        into identical rounds."""
        take, rest, seen = [], [], set()
        for item in pending:
            if len(take) < B and item[0] not in seen:
                take.append(item)
                seen.add(item[0])
            else:
                rest.append(item)
        return take, rest

    def _take_host(self) -> Tuple[np.ndarray, ...]:
        """This round's ingest selection as host arrays ``(sid, vals, ts,
        valid, its)`` padded to ``cfg.batch``; staged ring slots of the
        taken SUs are released."""
        B, C = self.cfg.batch, self.cfg.channels
        sid = np.zeros((B,), np.int32)
        vals = np.zeros((B, C), np.float32)
        ts = np.zeros((B,), np.int32)
        valid = np.zeros((B,), bool)
        its = np.zeros((B,), np.int32)
        take, self._pending = self._select_wave(self._pending, B)
        for i, (s, v, t, slot, stamp) in enumerate(take):
            sid[i], vals[i], ts[i], valid[i], its[i] = s, v, t, True, stamp
            if slot is not None:        # consumed by a round: its staged
                self._release_ring_slot(slot)   # ring slot is free again
        return sid, vals, ts, valid, its

    def _take_ingest(self) -> IngestBatch:
        """This round's ingest batch on the engine's device."""
        return IngestBatch(*(_tensor(a, self.device)
                             for a in self._take_host()))

    def _release_ring_slot(self, slot) -> None:
        """Hook: return a staged ingest-ring slot to the free pool (the
        sharded engine keys its pools by shard)."""
        self._ring_free.append(slot)

    # --------------------------------------------------------------- rounds
    def round(self) -> SinkBatch:
        """Run one four-stage engine round on the pending ingest batch and
        return the round's external sink."""
        self._last_base = self._rounds_done
        self.state, sink = self._step(self._run_tables, self.state,
                                      self._take_ingest())
        self._rounds_done += 1
        self._maybe_checkpoint()
        return sink

    def drain(self, max_rounds: int = 256) -> List[SinkBatch]:
        """Run rounds until the queue and the host backlog are empty.  With
        ``cfg.superstep > 1`` the rounds ride the superstep plane — K
        rounds per call, one spool readback per superstep — and the
        returned per-round sinks are rebuilt from the spools (host arrays,
        bit-identical to the per-round path)."""
        K = self.cfg.superstep
        if K > 1:
            sinks = []
            for spool in self.drain_spools(K, max_rounds):
                sinks.extend(self.spool_sinks(spool))
            return sinks
        sinks = []
        for _ in range(max_rounds):
            busy_host = bool(self._pending)
            sinks.append(self.round())
            if not busy_host and not bool(self.state.q_valid.any()):
                break
        return sinks

    def drain_spools(self, K: Optional[int] = None, max_rounds: int = 256):
        """Yield one :class:`SinkSpool` per superstep until the host
        backlog and the device queue are empty.  Rounds are quantised to
        K; never more than ``max_rounds`` rounds, except that
        ``max_rounds < K`` still runs one whole superstep."""
        K = K or self.cfg.superstep
        for _ in range(max(max_rounds // K, 1)):
            busy_host = bool(self._pending)
            yield self.superstep(K)
            if not busy_host and not bool(self.state.q_valid.any()):
                break

    # ----------------------------------------------------------- supersteps
    def _assign_rounds(self, K: int) -> List[Tuple[List, int, int]]:
        """Pack pending SUs into the (K, B) ingest grid by simulating K
        sequential ``_take_ingest`` selections; returns ``(entry, round,
        column)`` triples and leaves the unconsumed tail in ``_pending``."""
        B = self.cfg.batch
        assigned, pend = [], self._pending
        for k in range(K):
            take, pend = self._select_wave(pend, B)
            assigned += [(e, k, i) for i, e in enumerate(take)]
        self._pending = pend
        return assigned

    def _stage(self, K: int) -> None:
        """Superstep boundary: assign rounds, ship new payloads into free
        ring slots and rewrite every slot's routing tag — two host->device
        copies (the int32 planes and the payloads).  SUs already resident
        (the overflow queue) are only re-tagged."""
        R, C = self.cfg.ring_slots(K), self.cfg.channels
        if self._ring is None or self._ring_K != K:
            self._ring, self._ring_K = init_ring(self.cfg, K, self.device), K
            self._ring_free = list(range(R))
            for e in self._pending:     # slots of the old ring are void
                e[3] = None
        assigned = self._assign_rounds(K)
        # every SU consumed this superstep needs its payload on the device;
        # spill slots of carried SUs if free ones run out (the host keeps
        # every payload until consumption and re-ships the victim later)
        slotted = [e for e in self._pending if e[3] is not None]
        writes = []
        for e, _k, _i in assigned:
            if e[3] is None:
                if self._ring_free:
                    e[3] = self._ring_free.pop()
                else:                   # youngest carried SU spills its slot
                    victim = slotted.pop()
                    e[3], victim[3] = victim[3], None
                writes.append(e)
        # pre-ship the overflow: the earliest carried SUs claim leftover slots
        for e in self._pending:
            if not self._ring_free:
                break
            if e[3] is None:
                e[3] = self._ring_free.pop()
                writes.append(e)
        # int32 planes: w_slot, w_sid, w_ts, w_its, rnd, pos, valid
        ints = np.zeros((7, R), np.int32)
        ints[0] = R
        ints[4] = K
        w_vals = np.zeros((R, C), np.float32)
        for j, e in enumerate(writes):
            ints[0:4, j] = e[3], e[0], e[2], e[4]
            w_vals[j] = e[1]
        for e, k, i in assigned:
            ints[4:7, e[3]] = k, i, 1
        for e in self._pending:
            if e[3] is not None:
                ints[6, e[3]] = 1       # carried overflow stays resident
        d_ints = _tensor(ints, self.device)
        w_slot, w_sid, w_ts, w_its, rnd, pos, valid = d_ints
        self._ring = stage_ring(self._ring, w_slot, w_sid,
                                _tensor(w_vals, self.device), w_ts, w_its,
                                rnd, pos, valid.bool())
        self._ring_free += [e[3] for e, _k, _i in assigned]

    def superstep(self, K: Optional[int] = None) -> SinkSpool:
        """Run K rounds as one superstep: stage the ingest ring, enqueue
        the K rounds, return the device sink spool (read it back with
        ``spool_sinks``/``latency_records``)."""
        K = K or self.cfg.superstep
        self._stage(K)
        self._last_base = self._rounds_done
        spool = self._run_superstep(K)
        self._rounds_done += K
        self._maybe_checkpoint()
        return spool

    def _run_superstep(self, K: int) -> SinkSpool:
        """The K rounds alone (no staging, no readback): only enqueues
        device work."""
        self.state, spool, self._ring = self._superstep_fn(K)(
            self._run_tables, self.state, self._ring)
        return spool

    def _superstep_fn(self, K: int) -> Callable:
        """The current path's K-round closure (built once per (path, K))."""
        fn = self._supersteps.get(K)
        if fn is None:
            fn = self._supersteps[K] = self._make_superstep(
                K, self._path == "fused")
        return fn

    def spool_sinks(self, spool: SinkSpool,
                    K: Optional[int] = None) -> List[SinkBatch]:
        """Rebuild one superstep's per-round :class:`SinkBatch` list from
        the spool, as host numpy arrays — bit-identical to K sequential
        ``round()`` sinks (provided the spool did not overflow).  One
        readback of the spool."""
        S, C = self.cfg.sink_buffer, self.cfg.channels
        sid, vals, ts, its, rnd = (getattr(spool, f).cpu().numpy() for f in (
            "sid", "vals", "ts", "its", "rnd"))
        fill = int(spool.fill)
        K = K or self._ring_K or (int(rnd[:fill].max()) + 1 if fill else 1)
        sinks = []
        for k in range(K):
            b_sid = np.zeros((S,), np.int32)
            b_vals = np.zeros((S, C), np.float32)
            b_ts = np.zeros((S,), np.int32)
            b_valid = np.zeros((S,), bool)
            b_its = np.zeros((S,), np.int32)
            idx = np.nonzero(rnd[:fill] == k)[0]
            n = len(idx)
            b_sid[:n], b_vals[:n], b_ts[:n] = sid[idx], vals[idx], ts[idx]
            b_its[:n] = its[idx]
            b_valid[:n] = True
            sinks.append(SinkBatch(b_sid, b_vals, b_ts, b_valid, b_its))
        return sinks

    def latency_records(self, source, base: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
        """Per-record ingest->sink latency readback — the latency plane's
        host endpoint.  ``source`` is a :class:`SinkSpool` (one
        superstep), a :class:`SinkBatch` (one round), or a list of either;
        ``base`` is the engine-global round of the source's *first* round
        (default ``_last_base``: the latest ``round()``/``superstep()``).
        Returns flat host arrays ``{"sid", "tenant", "its", "round",
        "latency"}`` over the valid records: ``round`` is the global
        emission round (``base`` + the round within the superstep),
        ``latency = round - its`` in engine rounds, and ``tenant``
        resolves through the registry (-1 for unregistered sids)."""
        if base is None:
            base = self._last_base
        sources = source if isinstance(source, list) else [source]
        batches: List[Tuple[SinkBatch, int]] = []   # (batch, emission round)
        for src in sources:
            if isinstance(src, SinkSpool):
                for k, b in enumerate(self.spool_sinks(src)):
                    batches.append((b, base + k))
                base += self._ring_K or 1
            else:
                batches.append((src, base))
                base += 1
        t_of = np.full((self.cfg.n_streams,), -1, np.int32)
        for s in self.registry.streams:
            if s is not None:
                t_of[s.sid] = s.tenant
        out = {k: [] for k in ("sid", "tenant", "its", "round", "latency")}
        for b, rnd in batches:
            sid, its, valid = (
                (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x)).reshape(-1)
                for x in (b.sid, b.its, b.valid))
            idx = np.nonzero(valid)[0]
            s = sid[idx].astype(np.int32)
            i = its[idx].astype(np.int32)
            out["sid"].append(s)
            out["tenant"].append(t_of[np.clip(s, 0, t_of.shape[0] - 1)])
            out["its"].append(i)
            out["round"].append(np.full(idx.shape, rnd, np.int32))
            out["latency"].append(np.full(idx.shape, rnd, np.int32) - i)
        return {k: (np.concatenate(v) if v else np.zeros((0,), np.int32))
                for k, v in out.items()}

    # ---------------------------------------------------------- round paths
    def _round_path(self) -> str:
        """"fused" while the config asks for fusion and every admitted
        program is fusable (no transcendental opcodes), else "staged"."""
        return "fused" if (self.cfg.fused_round
                           and self.cfg.scheduler == "packed"
                           and bool(self._fusable_rows.all())) else "staged"

    def _select_path(self) -> None:
        """(Re)install the round and superstep closures of the current
        path."""
        self._path = path = self._round_path()
        fns = self._fns.get(path)
        if fns is None:
            fns = self._fns[path] = (self._make_step(path == "fused"), {})
        self._step, self._supersteps = fns

    def _make_step(self, fused: bool) -> Callable:
        """The round closure of one path (the sharded engine overrides
        this and :meth:`_make_superstep`)."""
        return make_step(self.cfg, self._fanout_fn, fused=fused,
                         use_kernel=self.use_kernel)

    def _make_superstep(self, K: int, fused: bool) -> Callable:
        return make_superstep(self.cfg, K, self._fanout_fn, fused=fused,
                              use_kernel=self.use_kernel)

    def _refresh_fusable(self) -> None:
        """Recompute from the program table the per-row fusability bitmap
        and the VM's step bound, then re-select the round path.  The round
        reads the tables with the program table cut to that bound (a NOP
        tail is the identity), so the VM's trip count is known on the host
        and no round reads one back."""
        progs = self.tables.progs.cpu().numpy()
        self._fusable_rows = rf_ref.fusable_rows(progs)
        self._cut_programs(progs)

    def _note_program(self, row, prog: Optional[np.ndarray]) -> None:
        """Single-row update after a program edit of ``tables.progs``
        (``row`` an index tuple or a sid; ``prog=None``: the row is the
        all-NOP program)."""
        self._fusable_rows[row] = rf_ref.fusable_program(prog)
        self._cut_programs(self.tables.progs.cpu().numpy())

    def _cut_programs(self, progs: np.ndarray) -> None:
        """Rewrite the round's program table, ``tables.progs`` cut to the
        step bound, in place.  The cut lives in one buffer of the full
        table's size, so its storage never moves (a re-lower to another
        shard shape excepted).  The bound only grows, since a NOP tail is
        the identity: its shape changes only when an edit needs more
        steps than any program before it, and then ``_sync_admitted``
        runs."""
        full = self.tables.progs
        buf = getattr(self, "_prog_buf", None)
        steps = pvm.program_steps(progs)
        old = None
        if buf is None or buf.numel() != full.numel() \
                or buf.device != full.device:
            buf = self._prog_buf = torch.empty(
                full.numel(), dtype=full.dtype, device=full.device)
        else:
            old = self._run_tables.progs
            steps = max(steps, old.shape[-2])
        shape = tuple(full.shape[:-2]) + (steps, full.shape[-1])
        cut = buf[:int(np.prod(shape))].view(shape)
        cut.copy_(full[..., :steps, :])
        self._run_tables = self.tables._replace(progs=cut)
        if old is None or old.shape != cut.shape:
            self._sync_admitted()
        self._select_path()

    def _sync_admitted(self) -> None:
        """Hook, called where the JAX package re-places the round's inputs:
        the round's program table changed shape or storage (see
        :meth:`_cut_programs`), :meth:`_install_snapshot` rebound every
        table and state tensor, or the durability plane edited the queue
        or the dead-letter spool (in place).  A captured round would be
        captured again at the first two; nothing is captured yet."""

    # ----------------------------------------------------- tenant QoS plane
    @staticmethod
    def _tid(tenant) -> int:
        return int(tenant.tid if hasattr(tenant, "tid") else tenant)

    def set_weight(self, tenant, weight: int) -> None:
        """Set a tenant's fair-share weight live (in place), clipped to
        ``[0, FAIR_SCALE]``; 0 exempts the tenant from shaping."""
        from repro_torch.core import admission
        admission.set_weight(self.tables, self._tid(tenant), weight)

    def set_quota(self, tenant, quota: int,
                  burst: Optional[int] = None) -> None:
        """Set a tenant's ingest quota live (in place): a token bucket
        refilled by ``quota`` per round up to ``burst`` (default
        ``quota``), both clipped to ``[0, QUOTA_MAX]``; the current bucket
        is clamped to the new burst.  ``quota=0`` removes the cap."""
        from repro_torch.core import admission
        admission.set_quota(self.tables, self.state, self._tid(tenant),
                            quota, quota if burst is None else burst)

    def set_breaker(self, window: Optional[int] = None,
                    threshold: Optional[int] = None,
                    amp_ceiling: Optional[int] = None) -> None:
        """Tune the circuit breaker live (in place): ``threshold`` faults
        within a ``window``-round span quarantine a stream; 0 disarms
        tripping (faults still count), ``amp_ceiling=0`` disarms the
        amplification class.  Omitted knobs keep their values."""
        from repro_torch.core import admission
        cur = self.tables.breaker.cpu().numpy().reshape(-1, 3)[0]
        w = int(cur[0]) if window is None else int(window)
        f = int(cur[1]) if threshold is None else int(threshold)
        c = int(cur[2]) if amp_ceiling is None else int(amp_ceiling)
        assert w >= 1 and f >= 0 and c >= 0
        admission.set_breaker(self.tables, [w, f, c])

    # ------------------------------------------------- dynamic admission
    # Live topology churn: every method below edits the running engine's
    # tables and state in place through :mod:`repro_torch.core.admission`;
    # no round closure is rebuilt.  Capacity rejections return None/False
    # and count in ``admission_rejected``.

    def _table_row(self, sid: int) -> Tuple:
        """Index tuple of stream ``sid``'s row in the device tables; the
        sharded engine addresses ``(shard, local)``."""
        return (int(sid),)

    def _place_sid(self, sid: int, tid: int, priority: int) -> None:
        """Hook: the sharded engine routes a newly admitted sid to a shard
        here."""

    def _released_sid(self, sid: int) -> None:
        """Hook: the sharded engine frees the sid's shard slot here."""

    def admit_stream(self, tenant, name: str, channels: Sequence[str],
                     *, priority: int = 0, service_object=None):
        """Admit a new simple (device-fed) stream on the running engine.
        Returns the Stream, or ``None`` when capacity is exhausted (the
        rejection is counted)."""
        try:
            s = self.registry.create_stream(tenant, name, channels,
                                            service_object=service_object)
        except CapacityError:
            self.admission_rejected += 1
            return None
        self._place_sid(s.sid, tenant.tid, priority)
        self._admit_row(s, priority)
        return s

    def admit_composite(self, tenant, name: str, channels: Sequence[str],
                        inputs: Sequence, transform: Optional[Dict[str, str]]
                        = None, *, pre_filter: Optional[str] = None,
                        post_filter: Optional[str] = None, priority: int = 0,
                        service_object=None, model_backed: bool = False):
        """Admit a composite stream (Service Object + subscriptions) live.
        Returns the Stream, or ``None`` on any capacity rejection."""
        try:
            s = self.registry.create_composite(
                tenant, name, channels, inputs, transform or {},
                pre_filter=pre_filter, post_filter=post_filter,
                service_object=service_object, model_backed=model_backed)
        except CapacityError:
            self.admission_rejected += 1
            return None
        self._place_sid(s.sid, tenant.tid, priority)
        self._admit_row(s, priority)
        return s

    def _admit_row(self, s, priority: int) -> None:
        from repro_torch.core import admission
        try:
            if s.composite:
                prog, consts = self.registry._compile_stream(s)
            else:
                prog, consts = pvm.empty_program(self.cfg.prog_len,
                                                 self.cfg.n_consts)
        except Exception:
            # bad user code must not leave a half-admitted stream behind
            self.registry.remove_stream(s.sid)
            self._released_sid(s.sid)
            raise
        row = self._table_row(s.sid)
        admission.admit_stream(self.tables, self.state, row, s.tenant,
                               len(s.channels), s.composite, s.model_backed,
                               priority, prog, consts)
        for src_sid in s.inputs:      # same append order as build_tables
            self._admit_edge(s.sid, src_sid)
        self._note_program(row, prog)

    def revoke_stream(self, stream) -> None:
        """Revoke a stream live: its row is cleared, every subscription
        referencing it is severed, queued SUs are purged into
        ``dropped_revoked`` (and the DLQ), and the sid is recycled by the
        next admission."""
        from repro_torch.core import admission
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        self.registry.remove_stream(sid)
        row = self._table_row(sid)
        admission.revoke_stream(self.tables, self.state, row, sid)
        self._released_sid(sid)
        self._note_program(row, None)           # the row is NOPs now

    def admit_subscription(self, stream, new_input, *,
                           replay: bool = False) -> bool:
        """Add a subscription edge to a running composite.  Returns False
        (counted) when in/out-degree capacity is exhausted.  With
        ``replay=True`` (and ``cfg.retention_slots > 0``), ``new_input``'s
        retained emissions are re-enqueued oldest-first *before* live
        data, so the late joiner catches up on history — at-least-once:
        existing subscribers see the replayed SUs too but discard them as
        stale (Listing-2 keep mask), while the joiner (never emitted)
        processes all of them."""
        try:
            self.registry.subscribe(stream, new_input)
        except CapacityError:
            self.admission_rejected += 1
            return False
        self._admit_edge(stream.sid, new_input.sid)
        if replay:
            self._replay_retained(new_input)
        return True

    def revoke_subscription(self, stream, old_input) -> None:
        """Remove one subscription edge from a running composite."""
        from repro_torch.core import admission
        self.registry.unsubscribe(stream, old_input)
        admission.revoke_subscription(
            self.tables, self._table_row(stream.sid),
            self._table_row(old_input.sid), stream.sid, old_input.sid)

    def _admit_edge(self, target_sid: int, src_sid: int) -> None:
        from repro_torch.core import admission
        if not admission.admit_subscription(
                self.tables, self._table_row(target_sid),
                self._table_row(src_sid), target_sid, src_sid):
            # the registry pre-checked capacity and liveness, so a device
            # rejection means the host mirror and tables diverged
            raise RuntimeError(
                f"device tables rejected edge {src_sid}->{target_sid} the "
                "registry accepted (host/device mismatch)")

    def swap_program(self, stream, transform: Dict[str, str],
                     pre_filter: Optional[str] = None,
                     post_filter: Optional[str] = None) -> None:
        """Replace a composite stream's user code live — the tables are
        data, the round closure is untouched (paper §IV-F)."""
        from repro_torch.core import admission
        s = self.registry.stream_of(
            stream.sid if hasattr(stream, "sid") else int(stream))
        if not s.composite:
            raise ValueError("only composite streams carry user code")
        s.transform = dict(transform)
        s.pre_filter = pre_filter
        s.post_filter = post_filter
        prog, consts = self.registry._compile_stream(s)
        row = self._table_row(s.sid)
        admission.swap_program(self.tables, row, prog, consts)
        self._note_program(row, prog)

    def inject_code(self, stream, transform: Dict[str, str],
                    pre_filter: Optional[str] = None,
                    post_filter: Optional[str] = None) -> None:
        """Alias of :meth:`swap_program` (its pre-admission-plane name)."""
        self.swap_program(stream, transform, pre_filter, post_filter)

    def rewire(self) -> None:
        """Re-lower the registry into the existing tables after
        ``Registry.subscribe``/new streams (same shapes, written in
        place).  The per-tenant QoS tables and the breaker knobs are kept:
        the registry does not mirror them."""
        prio = self.tables.priority.cpu().numpy()
        host = self.registry.build_tables(prio)
        for f in DeviceTables._fields:
            if f not in ("weight", "quota", "burst", "breaker"):
                getattr(self.tables, f).copy_(_tensor(getattr(host, f),
                                                      "cpu"))
        self._refresh_fusable()

    # ------------------------------------------------- fault-isolation plane
    def quarantine(self, stream) -> None:
        """Quarantine a stream by hand (the breaker's trip action, host
        triggered): its queued SUs purge to the DLQ as ``poisoned`` and the
        ingest/pop gates shed everything addressed to it until
        :meth:`unquarantine`.  The row keeps its registration, program and
        subscriptions.  Idempotent."""
        from repro_torch.core import admission
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        admission.quarantine_stream(self.tables, self.state,
                                    self._table_row(sid), sid)

    def unquarantine(self, stream) -> None:
        """Lift a stream's quarantine and reset its breaker window
        (``fault_total`` survives)."""
        from repro_torch.core import admission
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        admission.unquarantine_stream(self.state, self._table_row(sid))

    def is_quarantined(self, stream) -> bool:
        """Whether ``stream``'s row is currently quarantined."""
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        return bool(self.state.quarantined[self._table_row(sid)])

    # ------------------------------------------------------------- readback
    def value_of(self, stream) -> np.ndarray:
        """Last stored value of ``stream`` (host ``(channels,)`` f32)."""
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        return self.state.values[sid].cpu().numpy()

    def ts_of(self, stream) -> int:
        """Last emission timestamp of ``stream`` (``INT_MIN`` = never)."""
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        return int(self.state.timestamps[sid])

    def counters(self) -> Dict[str, int]:
        """The scalar stat counters as a host dict (keys: STAT_KEYS),
        summed over shards on the host by the sharded engine."""
        return {k: int(v.cpu().numpy().sum()) for k, v in
                self.state.stats.items()}

    def tenant_counters(self) -> Dict[str, np.ndarray]:
        """Per-tenant counters as host arrays (summed over shards):
        ``emitted``, ``queued``, ``dropped_quota`` and
        ``dropped_overflow``."""
        out = {}
        for key, field in (("emitted", "tenant_emitted"),
                           ("queued", "tenant_queued"),
                           ("dropped_quota", "tenant_dropped_quota"),
                           ("dropped_overflow", "tenant_dropped_overflow")):
            a = getattr(self.state, field).cpu().numpy()
            out[key] = a.sum(axis=0) if a.ndim == 2 else a
        return out

    def tenant_backlog(self, tenant=None):
        """Per-tenant queue occupancy after the last round (summed over
        shards): the int for one ``tenant``, or the ``(n_tenants,)``
        array."""
        occ = self.tenant_counters()["queued"]
        return occ if tenant is None else int(occ[self._tid(tenant)])

    def fault_counters(self) -> Dict[str, np.ndarray]:
        """Per-stream fault counters as by-sid host arrays:
        ``quarantined``, ``fault_count`` and ``fault_total``."""
        return {f: self._by_sid(getattr(self.state, f))
                for f in ("quarantined", "fault_count", "fault_total")}

    def _by_sid(self, x: torch.Tensor) -> np.ndarray:
        """A per-row state leaf as a host array in sid order (the sharded
        engine gathers it through its placement)."""
        return x.cpu().numpy()

    def dead_letters(self, clear: bool = True) -> List[DeadLetter]:
        """Drain the dead-letter spool: every SU dropped into a
        ``dropped_*`` counter since the last drain, in drop order
        (shard-major on the sharded engine); ``clear`` resets the spool
        cursor (in place, through the admission plane)."""
        st = self.state
        if st.dlq_sid.shape[-1] == 0:
            return []
        one = st.dlq_fill.dim() == 0        # single device: no shard axis
        sid, vals, ts, its, reason, tenant, fill = (
            getattr(st, f).cpu().numpy()[None] if one
            else getattr(st, f).cpu().numpy()
            for f in ("dlq_sid", "dlq_vals", "dlq_ts", "dlq_its",
                      "dlq_reason", "dlq_tenant", "dlq_fill"))
        letters = [DeadLetter(int(sid[s, i]), np.array(vals[s, i]),
                              int(ts[s, i]), DLQ_REASONS[int(reason[s, i])],
                              int(tenant[s, i]), int(its[s, i]))
                   for s in range(fill.shape[0]) for i in range(int(fill[s]))]
        if clear and letters:
            from repro_torch.core import admission
            admission.clear_dead_letters(self.state)
            self._sync_admitted()
        return letters

    def redeliver(self, letters: Optional[List[DeadLetter]] = None) -> int:
        """Resubmit dead letters (default: drain and clear the spool now).
        Quota-shed SUs were refused *before* phase 0 stored them, so they
        re-enter through normal ingest (a still-exhausted quota sheds them
        again); every other class was stored when it dropped, so it
        re-enqueues through the requeue edit, bypassing the phase-0 stale
        gate so historical timestamps survive.  Letters whose stream is no
        longer admittable — revoked *or* still quarantined — are refused:
        they go back into the spool (the respool edit, reasons and stamps
        kept) and count in ``stats["redeliver_rejected"]``.  Re-enqueues
        that overflow the queue drop (and dead-letter) again.  Returns the
        number submitted."""
        if letters is None:
            letters = self.dead_letters(clear=True)
        qmask = self.fault_counters()["quarantined"]
        live, rejected = [], []
        for lt in letters:
            registered = (0 <= lt.sid < len(self.registry.streams)
                          and self.registry.streams[lt.sid] is not None)
            if registered and not bool(qmask[lt.sid]):
                live.append(lt)
            else:
                rejected.append(lt)
        for lt in live:
            if lt.reason == "quota":
                self.post(lt.sid, lt.vals, lt.ts, its=lt.its)
        self._requeue_batch([(lt.sid, lt.vals, lt.ts, lt.tenant, lt.its)
                             for lt in live if lt.reason != "quota"])
        self._respool_rejected(rejected)
        return len(live)

    def _edit_width(self) -> int:
        """Pad width of one requeue/respool edit: every chunk has it."""
        return max(self.cfg.retention_slots, self.cfg.dlq_slots, 1)

    def _respool_rejected(self, letters: List[DeadLetter]) -> None:
        """Put refused dead letters back in the spool (original reason and
        stamps kept) and count them: one padded edit per chunk."""
        W, C = self._edit_width(), self.cfg.channels
        for ofs in range(0, len(letters), W):
            chunk = letters[ofs:ofs + W]
            sid = np.zeros((W,), np.int32)
            vals = np.zeros((W, C), np.float32)
            ts = np.zeros((W,), np.int32)
            reason = np.zeros((W,), np.int32)
            tenant = np.zeros((W,), np.int32)
            its = np.zeros((W,), np.int32)
            valid = np.zeros((W,), bool)
            for i, lt in enumerate(chunk):
                sid[i], vals[i], ts[i] = lt.sid, lt.vals, lt.ts
                reason[i] = DLQ_REASONS.index(lt.reason)
                tenant[i], its[i], valid[i] = lt.tenant, lt.its, True
            self._apply_respool(sid, vals, ts, reason, tenant, its, valid)

    def _apply_respool(self, sid, vals, ts, reason, tenant, its,
                       valid) -> None:
        """Hook: one padded respool edit (the sharded engine routes each
        letter to its owner shard)."""
        from repro_torch.core import admission
        admission.respool(self.state, *(_tensor(a, self.device) for a in (
            sid, vals, ts, reason, tenant, its, valid)))
        self._sync_admitted()

    def _replay_retained(self, src) -> int:
        """Re-enqueue ``src``'s retained emissions oldest-first (the replay
        half of ``admit_subscription(..., replay=True)``), each with its
        original ingest stamp."""
        Rr = self.cfg.retention_slots
        sid = src.sid if hasattr(src, "sid") else int(src)
        if Rr == 0:
            return 0
        row = self._table_row(sid)
        count = int(self.state.ret_count[row])
        if count == 0:
            return 0
        vals, ts, r_its = (getattr(self.state, f)[row].cpu().numpy()
                           for f in ("ret_vals", "ret_ts", "ret_its"))
        tenant = self.registry.stream_of(sid).tenant
        n = min(count, Rr)
        slots = [(count - n + i) % Rr for i in range(n)]
        return self._requeue_batch([(sid, vals[j], int(ts[j]), tenant,
                                     int(r_its[j])) for j in slots])

    def _requeue_batch(self, items: List[Tuple]) -> int:
        """Ship ``(sid, vals, ts, tenant, its)`` items into the queue
        through the requeue edit, in chunks of one pad width."""
        W, C = self._edit_width(), self.cfg.channels
        for ofs in range(0, len(items), W):
            chunk = items[ofs:ofs + W]
            sid = np.zeros((W,), np.int32)
            vals = np.zeros((W, C), np.float32)
            ts = np.zeros((W,), np.int32)
            valid = np.zeros((W,), bool)
            tenant = np.zeros((W,), np.int32)
            its = np.zeros((W,), np.int32)
            for i, (s, v, t, tn, stamp) in enumerate(chunk):
                sid[i], vals[i], ts[i] = s, v, t
                valid[i], tenant[i], its[i] = True, tn, stamp
            self._apply_requeue(sid, vals, ts, valid, tenant, its)
        return len(items)

    def _apply_requeue(self, sid, vals, ts, valid, tenant, its) -> None:
        """Hook: one padded requeue edit (the sharded engine routes each
        item to its owner shard)."""
        from repro_torch.core import admission
        admission.requeue(self.state, *(_tensor(a, self.device) for a in (
            sid, vals, ts, valid, tenant, its)))
        self._sync_admitted()

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """The full engine as ``(arrays, meta)`` — the keys and layout of
        the JAX package's ``StreamEngine.snapshot()``: device tables,
        engine state (stats included), the pending backlog, and a JSON-able
        ``meta`` with the registry mirror and host counters.  The arrays
        are host copies (later in-place edits do not reach them).  The
        ingest ring is not captured: every unconsumed SU is also in the
        host backlog, from which a restore re-stages."""
        arrays: Dict[str, np.ndarray] = {}
        for f in DeviceTables._fields:
            arrays[f"tables/{f}"] = _host_copy(getattr(self.tables, f))
        for f in EngineState._fields:
            if f != "stats":
                arrays[f"state/{f}"] = _host_copy(getattr(self.state, f))
        for k in STAT_KEYS:
            arrays[f"state/stats/{k}"] = _host_copy(self.state.stats[k])
        C = self.cfg.channels
        p = self._pending
        arrays["pending/sid"] = np.array([e[0] for e in p], np.int32)
        arrays["pending/vals"] = (np.stack([e[1] for e in p]).astype(np.float32)
                                  if p else np.zeros((0, C), np.float32))
        arrays["pending/ts"] = np.array([e[2] for e in p], np.int32)
        arrays["pending/its"] = np.array([e[4] for e in p], np.int32)
        meta = {"format": 1, "kind": "single",
                "registry": self.registry.to_snapshot(),
                "admission_rejected": self.admission_rejected,
                "steps_done": self._steps_done,
                "rounds_done": self._rounds_done}
        return arrays, meta

    def _install_snapshot(self, arrays: Dict[str, np.ndarray],
                          meta: dict) -> None:
        """Overwrite this engine's tables, state and backlog with a
        snapshot's.  Snapshots from before the fault plane take the
        breaker knobs from the config and zero fault leaves and stats
        (nothing quarantined), and those from before the latency plane
        zero ingest stamps — the JAX package's defaults."""
        dev = self.device
        brk = arrays.get("tables/breaker")
        if brk is None:
            brk = np.array([self.cfg.fault_window, self.cfg.fault_threshold,
                            self.cfg.fault_amp_ceiling], np.int32)
            if arrays["tables/active"].ndim == 2:
                brk = np.tile(brk[None], (arrays["tables/active"].shape[0], 1))
        self.tables = DeviceTables(**{
            f: _tensor(brk if f == "breaker" else arrays[f"tables/{f}"], dev)
            for f in DeviceTables._fields})
        row_shape = arrays["state/timestamps"].shape
        fill = {"quarantined": np.zeros(row_shape, bool),
                "fault_count": np.zeros(row_shape, np.int32),
                "fault_epoch": np.zeros(row_shape, np.int32),
                "fault_total": np.zeros(row_shape, np.int32),
                "round_idx": np.zeros(np.shape(arrays["state/seq"]), np.int32)}
        st = {f: _tensor(arrays[f"state/{f}"] if f"state/{f}" in arrays
                         else fill[f], dev)
              for f in EngineState._fields if f != "stats"}
        stat0 = np.zeros_like(np.asarray(arrays["state/stats/ingested"]))
        st["stats"] = {k: _tensor(arrays.get(f"state/stats/{k}", stat0), dev)
                       for k in STAT_KEYS}
        self.state = EngineState(**st)
        p_sid, p_vals, p_ts = (arrays[f"pending/{k}"]
                               for k in ("sid", "vals", "ts"))
        p_its = arrays.get("pending/its", np.zeros_like(p_sid))
        # ring slots are per engine: restored SUs re-stage from here
        self._pending = [[int(p_sid[i]), np.array(p_vals[i], np.float32),
                          int(p_ts[i]), None, int(p_its[i])]
                         for i in range(p_sid.shape[0])]
        self.admission_rejected = int(meta.get("admission_rejected", 0))
        self._steps_done = int(meta.get("steps_done", 0))
        self._rounds_done = int(meta.get("rounds_done", 0))
        self._last_base = self._rounds_done
        self._ring, self._ring_K, self._ring_free = None, 0, []
        self._bind_fns()
        self._refresh_fusable()
        self._sync_admitted()

    def checkpoint_to(self, path: Optional[str], keep: int = 3):
        """Attach a :class:`~repro_torch.checkpoint.ckpt.CheckpointManager`
        at ``path``: every ``cfg.checkpoint_every``-th superstep boundary
        (a round counts as a superstep of one) snapshots the engine and
        writes it asynchronously, keeping the newest ``keep``
        checkpoints.  Returns the manager (``wait()`` on it before reading
        the directory; recover with :func:`restore_engine`).
        ``path=None`` detaches the manager after awaiting any write in
        flight."""
        from repro_torch.checkpoint.ckpt import CheckpointManager
        if path is None:
            if self._ckpt is not None:
                self._ckpt.wait()
            self._ckpt = None
            return None
        self._ckpt = CheckpointManager(path, keep=keep)
        return self._ckpt

    def _maybe_checkpoint(self) -> None:
        """Superstep-boundary hook, after the rounds were enqueued: count
        the boundary and, when the cadence lands and a manager is
        attached, snapshot (a device->host copy) and save in the
        background."""
        self._steps_done += 1
        every = self.cfg.checkpoint_every
        if self._ckpt is not None and every > 0 \
                and self._steps_done % every == 0:
            arrays, meta = self.snapshot()
            self._ckpt.save_async(self._steps_done, arrays, extra=meta)

    # ---------------------------------------------------------- elastic mesh
    def resize(self, n_shards: int, *,
               partition: Optional[str] = None) -> "StreamEngine":
        """Live shard scale-out/in at a superstep boundary: re-shards the
        engine *in place* to ``n_shards`` and returns ``self``, the object
        morphing between :class:`StreamEngine` (``n_shards == 1``) and the
        sharded engine, so every holder of the reference keeps a valid
        engine.  The mechanism is the durability plane: a
        :meth:`snapshot`, re-laid out by
        :func:`~repro_torch.distributed.stream_sharding.reshard_snapshot`
        (rows, retention rings, queues and dead letters move to their new
        owner shards), then installed — so ``resize(M)`` equals
        ``restore_engine(snapshot(), n_shards=M)``.  The registry object
        (and every Stream handle it issued) survives; only its ``cfg``
        moves.  A return to a layout seen before reuses its round
        closures.  Token buckets restart, and scale-in can overflow the
        smaller per-shard queues: those SUs are counted and
        dead-lettered."""
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards == self.cfg.n_shards and \
                (partition is None or partition == self.cfg.partition):
            return self
        from repro_torch.distributed import stream_sharding as _sh
        arrays, meta = _sh.reshard_snapshot(*self.snapshot(), n_shards,
                                            partition=partition)
        self.cfg = self.registry.cfg = EngineConfig(
            **meta["registry"]["cfg"]).validate()
        if n_shards > 1:
            self.__class__ = _sh.ShardedStreamEngine
        else:
            self.__class__ = StreamEngine
            for attr in ("plan", "gmap", "_occupancy", "_spare", "_holes",
                         "_ring_dirty"):
                self.__dict__.pop(attr, None)
        self._install_snapshot(arrays, meta)
        return self


def create_engine(registry: Registry, *, device="cuda", **kw) -> StreamEngine:
    """Build the engine for ``registry.cfg`` on ``device`` (CUDA by
    default): a :class:`StreamEngine` when ``cfg.n_shards == 1``, else the
    sharded engine, its shards emulated on the one device
    (:mod:`repro_torch.distributed.stream_sharding`)."""
    if registry.cfg.n_shards > 1:
        from repro_torch.distributed.stream_sharding import \
            ShardedStreamEngine
        return ShardedStreamEngine(registry, device=device, **kw)
    return StreamEngine(registry, device=device, **kw)


def restore_engine(source, *, step: Optional[int] = None, device="cuda",
                   fanout_fn: Callable = fanout_reference,
                   n_shards: Optional[int] = None,
                   partition: Optional[str] = None, **kw):
    """Rebuild a running engine on ``device`` from a snapshot — the
    recovery half of ``StreamEngine.snapshot()``, of this package or of
    the JAX package.

    ``source`` is a checkpoint directory, a
    :class:`~repro_torch.checkpoint.ckpt.CheckpointManager`, or an
    ``(arrays, meta)`` pair.  The registry mirror in ``meta`` rebuilds
    the host control plane (with its exact :class:`EngineConfig`), the
    snapshot's kind picks the engine class (single or sharded), and
    tables, state and backlog are installed verbatim: the continuation is
    bit-identical to the uninterrupted run.  Returns ``None`` when no
    checkpoint exists yet (``step=None`` picks the newest *valid* one,
    skipping a torn or corrupt newer one; an explicit ``step`` raises
    :class:`~repro_torch.checkpoint.ckpt.CheckpointCorrupt` on damage).

    ``n_shards``/``partition`` re-shard the snapshot before it is
    installed (:func:`~repro_torch.distributed.stream_sharding.
    reshard_snapshot`, the mapping ``StreamEngine.resize`` uses), so an
    N-shard checkpoint restores into an M-shard engine.  ``**kw`` goes to
    the engine (``use_kernel``)."""
    if isinstance(source, tuple):
        arrays, meta = source
    else:
        from repro_torch.checkpoint import ckpt as _ckpt
        if isinstance(source, _ckpt.CheckpointManager):
            if step is None:
                step, arrays, meta = source.load_latest()
            else:
                source.wait()
                arrays, meta = _ckpt.load(source.path, step)
        elif step is None:
            step, arrays, meta = _ckpt.load_latest_valid(os.fspath(source))
        else:
            arrays, meta = _ckpt.load(os.fspath(source), step)
        if arrays is None:
            return None
    if n_shards is not None or partition is not None:
        cfg0 = EngineConfig(**meta["registry"]["cfg"])
        want = int(n_shards) if n_shards is not None else cfg0.n_shards
        if want != cfg0.n_shards or \
                (partition or cfg0.partition) != cfg0.partition:
            from repro_torch.distributed.stream_sharding import \
                reshard_snapshot
            arrays, meta = reshard_snapshot(arrays, meta, want,
                                            partition=partition)
    registry = Registry.from_snapshot(meta["registry"])
    if meta.get("kind") == "sharded":
        from repro_torch.distributed.stream_sharding import \
            ShardedStreamEngine
        eng = ShardedStreamEngine(registry, device=device,
                                  fanout_fn=fanout_fn, **kw)
    else:
        eng = StreamEngine(registry, device=device, fanout_fn=fanout_fn,
                           **kw)
    eng._install_snapshot(arrays, meta)
    return eng


def engine_from_snapshot(arrays: Dict[str, np.ndarray], meta: dict, *,
                         device="cuda", **kw) -> StreamEngine:
    """:func:`restore_engine` of an in-memory ``(arrays, meta)``
    snapshot."""
    return restore_engine((arrays, meta), device=device, **kw)
