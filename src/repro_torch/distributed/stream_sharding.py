"""Sharded stream engine: the pub/sub plane partitioned into shards — the
PyTorch port of the JAX package's ``repro.distributed.stream_sharding``.

Every shard owns a block of sids (contiguous, or a tenant-hash bucket)
and its own :class:`~repro_torch.core.engine.EngineState` slice — values,
timestamps, pending-SU queue, seq counter, stats, dead-letter spool —
while the four-stage round runs per shard.  Cross-shard subscriptions are
served by an **exchange stage** between stage 1 (fan-out) and stage 2
(fetch): work items bound for a sid another shard owns are compacted into
fixed-size per-destination buckets and exchanged; overflow is counted in
``stats["dropped_overflow"]`` and dead-lettered, never silent.  Co-input
fetches read a snapshot of every shard's values taken after every shard's
ingest, so the Listing-2 semantics are those of the single-device engine:
sharded == single-device bitwise whenever no bucket overflows
(``exchange_slots=0``) and every round drains every queue.

The shards are emulated on one device: every per-shard table and state
leaf carries a leading ``(n_shards,)`` axis (the layout of the JAX
package's sharded arrays read back with ``np.asarray``), the JAX
package's ``all_gather`` of values and timestamps becomes one gather of
every shard's rows by ``sid_to_flat`` (the ``by_sid_snapshot`` kernel,
which reads the shards' planes in place), and its two
``all_to_all`` calls become a transpose of the ``(S, S, E, ...)`` buckets
across the sending-shard axis.  The round is cut at those collectives:

    phase 0 + pop      every shard (the snapshot follows every ingest)
    snapshot           values and timestamps by sid (one
                       ``by_sid_snapshot`` launch)
    stage 1 + compact  every shard's ``fanout_fn``; one
                       ``exchange_compact`` launch serves all senders
    exchange           a transpose
    stages 2-4 + fault every shard; on the fused path one
                       ``apply_programs`` launch serves all shards

Inside each part a Python loop runs the single-device stage functions on
each shard's views.  Live churn (admission placement, ``rebalance``)
edits tables, state and the replicated lookup maps in place.  A sharded
snapshot adds the lookup maps and the placement plan to the
single-device one; :func:`reshard_snapshot` re-lays any snapshot out for
another shard count, which is how ``StreamEngine.resize`` and a
cross-shard-count ``restore_engine`` move the plane (the elastic plane).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import admission
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import (
    BOOL, DLQ_OVERFLOW, DLQ_POISONED, DLQ_REVOKED, F32, I32, INT_MIN,
    STAT_KEYS, DeviceTables, EngineState, IngestBatch, IngestRing, SinkBatch,
    SinkSpool, StreamEngine, _add_drop, _count, _host_copy, _inc,
    _init_spool, _pop, _set_drop, _tensor, dlq_append, fanout_reference,
    fault_events,
    fault_phase, ingest_phase, process_work_items, ring_grid, spool_round,
    store_and_emit, tenant_occupancy)
from repro_torch.core.registry import EngineTables
from repro_torch.kernels.round_fuse import ref as rf_ref
from repro_torch.kernels.round_fuse.ops import apply_programs, exchange_compact
from repro_torch.kernels.stream_dispatch.ops import by_sid_snapshot

# --------------------------------------------------------------------------
# partitioner
# --------------------------------------------------------------------------

class ShardPlan(NamedTuple):
    """Static placement of the stream space on the shards."""
    n_shards: int
    n_local: int                  # padded per-shard stream capacity
    sid_to_shard: np.ndarray      # (N,) int32 — the global sid -> shard map
    sid_to_local: np.ndarray      # (N,) int32 row within the owner's slice
    sid_to_flat: np.ndarray       # (N,) int32 == shard * n_local + local
    local_to_sid: np.ndarray      # (n_shards, n_local) int32, -1 pad


def plan_partition(cfg: EngineConfig, tenant_of_sid: np.ndarray,
                   n_shards: Optional[int] = None,
                   partition: Optional[str] = None) -> ShardPlan:
    """Assign every sid — spare rows included, so admissions can claim
    them later — a ``(shard, local)`` slot: ``"block"`` gives contiguous
    sid ranges, ``"tenant"`` hashes the owning tenant so one tenant's
    pipeline stays together.  ``n_local`` is the padded per-shard row
    count (``"tenant"`` pads to the largest bucket; unmapped rows are
    "holes").  The maps are mutable numpy arrays the sharded engine edits
    in place as placements change."""
    N = cfg.n_streams
    n_shards = int(n_shards or cfg.n_shards)
    partition = partition or cfg.partition
    sids = np.arange(N)
    if partition == "block":
        n_local = -(-N // n_shards)
        sid_to_shard = sids // n_local
        sid_to_local = sids % n_local
    elif partition == "tenant":
        sid_to_shard = np.asarray(tenant_of_sid, np.int64) % n_shards
        counts = np.zeros(n_shards, np.int64)
        sid_to_local = np.zeros(N, np.int64)
        for sid in range(N):
            s = sid_to_shard[sid]
            sid_to_local[sid] = counts[s]
            counts[s] += 1
        n_local = max(int(counts.max(initial=1)), 1)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    sid_to_flat = sid_to_shard * n_local + sid_to_local
    local_to_sid = np.full((n_shards, n_local), -1, np.int32)
    local_to_sid[sid_to_shard, sid_to_local] = sids
    return ShardPlan(n_shards, n_local,
                     sid_to_shard.astype(np.int32),
                     sid_to_local.astype(np.int32),
                     sid_to_flat.astype(np.int32), local_to_sid)


def shard_tables(tables: EngineTables, plan: ShardPlan) -> EngineTables:
    """Permute the global table rows into (n_shards, n_local, ...) slices.
    Pad rows are inert (no edges, NOP programs, ``active=False``), like
    revoked rows, so admission can claim them with table edits.  The
    per-tenant QoS tables and the breaker knobs get one copy per shard."""
    S, L = plan.n_shards, plan.n_local

    def scatter(rows: np.ndarray, fill) -> np.ndarray:
        out = np.full((S, L) + rows.shape[1:], fill, rows.dtype)
        out[plan.sid_to_shard, plan.sid_to_local] = rows
        return out

    return EngineTables(
        in_table=scatter(tables.in_table, -1),
        in_count=scatter(tables.in_count, 0),
        out_table=scatter(tables.out_table, -1),
        out_count=scatter(tables.out_count, 0),
        progs=scatter(tables.progs, 0),
        consts=scatter(tables.consts, 0),
        is_composite=scatter(tables.is_composite, False),
        tenant=scatter(tables.tenant, 0),
        priority=scatter(tables.priority, 0),
        n_channels=scatter(tables.n_channels, 1),
        model_backed=scatter(tables.model_backed, False),
        active=scatter(tables.active, False),
        weight=np.tile(tables.weight[None], (S, 1)),
        quota=np.tile(tables.quota[None], (S, 1)),
        burst=np.tile(tables.burst[None], (S, 1)),
        breaker=np.tile(tables.breaker[None], (S, 1)),
    )


class GlobalMaps(NamedTuple):
    """Small lookup tables every shard reads (by global sid)."""
    sid_to_shard: torch.Tensor    # (N,)
    sid_to_local: torch.Tensor    # (N,)
    sid_to_flat: torch.Tensor     # (N,)
    priority: torch.Tensor        # (N,) by global sid (queues hold sids)

    @classmethod
    def build(cls, priority: Optional[np.ndarray], plan: ShardPlan,
              device) -> "GlobalMaps":
        if priority is None:
            priority = np.zeros(plan.sid_to_shard.shape, np.int32)
        return cls(_tensor(plan.sid_to_shard, device),
                   _tensor(plan.sid_to_local, device),
                   _tensor(plan.sid_to_flat, device),
                   _tensor(np.asarray(priority, np.int32), device))


def _place_sid_op(gmap: GlobalMaps, sid: int, shard: int, local: int,
                  n_local: int, priority: int) -> None:
    """Point one global sid at a ``(shard, local)`` slot in the lookup
    maps, in place — the map half of a live admission or migration."""
    gmap.sid_to_shard[sid] = shard
    gmap.sid_to_local[sid] = local
    gmap.sid_to_flat[sid] = shard * n_local + local
    gmap.priority[sid] = priority


def _stage_ring_op(ring: IngestRing, w_slot, w_sid, w_vals, w_ts, w_its,
                   rnd, pos, valid) -> IngestRing:
    """:func:`repro_torch.core.engine.stage_ring` for every shard's ring
    slice at once: (S, R)-padded payload deltas (``w_slot == R`` drops)
    are scattered into the flattened (S * R) rings and every slot's
    routing tag is rewritten."""
    S, R = ring.sid.shape
    base = torch.arange(S, device=w_slot.device)[:, None] * R
    flat = torch.where(w_slot < R, base + w_slot, S * R).reshape(-1)

    def put(x, src):
        return _set_drop(x.reshape((S * R,) + x.shape[2:]), flat,
                         src.reshape((S * R,) + src.shape[2:])
                         ).reshape(x.shape)

    return IngestRing(sid=put(ring.sid, w_sid), vals=put(ring.vals, w_vals),
                      ts=put(ring.ts, w_ts), its=put(ring.its, w_its),
                      rnd=rnd, pos=pos, valid=valid)


def sharded_init_state(cfg: EngineConfig, plan: ShardPlan,
                       device) -> EngineState:
    """Per-shard EngineState slices stacked on a leading shard axis."""
    S, L, C, Q = plan.n_shards, plan.n_local, cfg.channels, cfg.queue
    T, Rr, D = cfg.n_tenants, cfg.retention_slots, cfg.dlq_slots

    def z(shape, dtype=I32):
        return torch.zeros((S,) + shape, dtype=dtype, device=device)

    return EngineState(
        values=z((L, C), F32),
        timestamps=torch.full((S, L), INT_MIN, dtype=I32, device=device),
        q_sid=z((Q,)), q_vals=z((Q, C), F32), q_ts=z((Q,)), q_its=z((Q,)),
        q_seq=z((Q,)), q_valid=z((Q,), BOOL), seq=z(()),
        tenant_emitted=z((T,)), tokens=z((T,)), tenant_queued=z((T,)),
        tenant_dropped_quota=z((T,)), tenant_dropped_overflow=z((T,)),
        ret_vals=z((L, Rr, C), F32), ret_ts=z((L, Rr)), ret_its=z((L, Rr)),
        ret_count=z((L,)),
        dlq_sid=z((D,)), dlq_vals=z((D, C), F32), dlq_ts=z((D,)),
        dlq_its=z((D,)), dlq_reason=z((D,)), dlq_tenant=z((D,)),
        dlq_fill=z(()),
        quarantined=z((L,), BOOL), fault_count=z((L,)), fault_epoch=z((L,)),
        fault_total=z((L,)), round_idx=z(()),
        stats={k: z(()) for k in STAT_KEYS},
    )


# table fields with one copy per shard (not row-indexed)
_REPL_FIELDS = ("weight", "quota", "burst", "breaker")


def reshard_snapshot(arrays, meta, n_shards: int,
                     partition: Optional[str] = None):
    """Re-lay an engine snapshot out for another shard count (or partition
    scheme) — the migration core of the elastic plane, equal to the JAX
    package's ``reshard_snapshot`` bit for bit.  Returns a new ``(arrays,
    meta)`` pair installable at ``n_shards`` (``kind="sharded"`` above 1,
    ``"single"`` at 1); the inputs are not changed.  Both
    ``StreamEngine.resize`` and a cross-shard-count ``restore_engine``
    route through here, which makes restore the oracle of resize.

    Everything runs on host numpy at a superstep boundary:

    * per-stream table rows and per-sid state (values, timestamps,
      retention rings, fault counters) are gathered into by-sid order and
      scattered again through a fresh :func:`plan_partition` /
      :func:`shard_tables` layout, whose hole fills match inert rows;
    * queued SUs are drained shard by shard in FIFO (``q_seq``) order and
      re-enqueued on each sid's new owner shard; entries beyond a shard's
      ``cfg.queue`` on scale-in are counted (``dropped_overflow``,
      ``purged``, per tenant) and dead-lettered, never silently lost;
    * dead letters re-spool on their sid's new owner (saturating at
      ``cfg.dlq_slots`` per shard, like any spool write);
    * per-tenant and stat totals are summed over the old shards and put on
      shard 0 (readback sums shards); ``tenant_queued`` is recounted from
      the moved queues; token buckets restart empty.
    """
    cfg = EngineConfig(**meta["registry"]["cfg"])
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    new_cfg = dataclasses.replace(
        cfg, n_shards=n_shards,
        partition=partition or cfg.partition).validate()
    N, C, Q, T = cfg.n_streams, cfg.channels, cfg.queue, cfg.n_tenants
    Rr, D = cfg.retention_slots, cfg.dlq_slots

    # ---- the source as by-sid / flat host views ---------------------------
    if meta.get("kind") == "sharded":
        old_flat = np.asarray(arrays["plan/sid_to_flat"], np.int64)

        def by_sid(x):
            x = np.asarray(x)       # explicit leading dim: zero-size leaves
            return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])[
                old_flat]

        def repl(x):                # one copy per shard: any is canonical
            return np.asarray(x)[0]

        def lead(x):
            return np.asarray(x)

        def tot(x):                 # totals live summed over the shards
            x = np.asarray(x)
            return np.array(x.sum(axis=0), x.dtype)
    else:
        def by_sid(x):
            return np.asarray(x)

        repl = by_sid

        def lead(x):                # the single layout lacks the shard axis
            return np.asarray(x)[None]

        def tot(x):
            return np.array(x)      # a copy: totals are changed below

    def tab_leaf(f):
        src = arrays.get(f"tables/{f}")
        if src is None:     # a snapshot from before the fault plane
            return np.array([cfg.fault_window, cfg.fault_threshold,
                             cfg.fault_amp_ceiling], np.int32)
        return (repl if f in _REPL_FIELDS else by_sid)(src)

    tab = {f: tab_leaf(f) for f in DeviceTables._fields}
    tenant_flat = tab["tenant"].astype(np.int64)
    per_sid = {f: by_sid(arrays[f"state/{f}"])
               for f in ("values", "timestamps",
                         "ret_vals", "ret_ts", "ret_its", "ret_count")}
    for f, dt in (("quarantined", bool), ("fault_count", np.int32),
                  ("fault_epoch", np.int32), ("fault_total", np.int32)):
        src = arrays.get(f"state/{f}")
        per_sid[f] = by_sid(src) if src is not None else np.zeros((N,), dt)
    r_idx = np.asarray(arrays.get("state/round_idx", 0))
    round_idx = np.int32(r_idx.max() if r_idx.ndim else r_idx)

    # queued SUs in shard-major FIFO order
    q_sid, q_vals = lead(arrays["state/q_sid"]), lead(arrays["state/q_vals"])
    q_ts, q_seq = lead(arrays["state/q_ts"]), lead(arrays["state/q_seq"])
    q_its = lead(arrays["state/q_its"])
    q_valid = lead(arrays["state/q_valid"])
    entries = []
    for s in range(q_sid.shape[0]):
        idx = np.nonzero(q_valid[s])[0]
        idx = idx[np.argsort(q_seq[s, idx], kind="stable")]
        entries.extend((int(q_sid[s, i]), np.array(q_vals[s, i]),
                        int(q_ts[s, i]), int(q_its[s, i])) for i in idx)

    # dead letters in drop (shard-major, spool) order
    d_sid, d_ts = lead(arrays["state/dlq_sid"]), lead(arrays["state/dlq_ts"])
    d_vals = lead(arrays["state/dlq_vals"])
    d_its = lead(arrays["state/dlq_its"])
    d_reason = lead(arrays["state/dlq_reason"])
    d_tenant = lead(arrays["state/dlq_tenant"])
    d_fill = np.atleast_1d(np.asarray(arrays["state/dlq_fill"]))
    letters = [(int(d_sid[s, i]), np.array(d_vals[s, i]), int(d_ts[s, i]),
                int(d_its[s, i]), int(d_reason[s, i]), int(d_tenant[s, i]))
               for s in range(d_sid.shape[0]) for i in range(int(d_fill[s]))]

    totals = {k: tot(arrays[f"state/stats/{k}"]) for k in STAT_KEYS}
    t_emitted = tot(arrays["state/tenant_emitted"])
    t_drop_quota = tot(arrays["state/tenant_dropped_quota"])
    t_drop_over = tot(arrays["state/tenant_dropped_overflow"])

    # ---- rebuild at the target shard count --------------------------------
    plan = plan_partition(new_cfg, tenant_flat)
    sh_tab = shard_tables(EngineTables(**tab), plan)
    S2, L2 = plan.n_shards, plan.n_local
    flat = plan.sid_to_flat

    def scatter(x, fill, dtype):
        out = np.full((S2 * L2,) + x.shape[1:], fill, dtype)
        out[flat] = x
        return out.reshape((S2, L2) + x.shape[1:])

    row_fill = {"values": (0, np.float32), "timestamps": (INT_MIN, np.int32),
                "ret_vals": (0, np.float32), "ret_ts": (0, np.int32),
                "ret_its": (0, np.int32), "ret_count": (0, np.int32),
                "quarantined": (False, bool), "fault_count": (0, np.int32),
                "fault_epoch": (0, np.int32), "fault_total": (0, np.int32)}
    rows = {f: scatter(per_sid[f], *fd) for f, fd in row_fill.items()}

    nq_sid = np.zeros((S2, Q), np.int32)
    nq_vals = np.zeros((S2, Q, C), np.float32)
    nq_ts = np.zeros((S2, Q), np.int32)
    nq_its = np.zeros((S2, Q), np.int32)
    nq_seq = np.zeros((S2, Q), np.int32)
    nq_valid = np.zeros((S2, Q), bool)
    fill = np.zeros((S2,), np.int64)
    t_queued = np.zeros((S2, T), np.int32)
    for sid, vals, ts, its in entries:
        sid_c = min(max(sid, 0), N - 1)
        s = int(plan.sid_to_shard[sid_c])
        tn = min(max(int(tenant_flat[sid_c]), 0), T - 1)
        k = int(fill[s])
        if k < Q:
            nq_sid[s, k], nq_vals[s, k], nq_ts[s, k] = sid, vals, ts
            nq_its[s, k] = its
            nq_seq[s, k], nq_valid[s, k] = k, True
            fill[s] = k + 1
            t_queued[s, tn] += 1
        else:
            # scale-in put more SUs on this shard than its queue holds:
            # counted and dead-lettered, like any overflow
            totals["dropped_overflow"] += 1
            totals["purged"] += 1
            t_drop_over[tn] += 1
            letters.append((sid, np.asarray(vals, np.float32), ts, its,
                            DLQ_OVERFLOW, tn))

    nd_sid = np.zeros((S2, D), np.int32)
    nd_vals = np.zeros((S2, D, C), np.float32)
    nd_ts = np.zeros((S2, D), np.int32)
    nd_its = np.zeros((S2, D), np.int32)
    nd_reason = np.zeros((S2, D), np.int32)
    nd_tenant = np.zeros((S2, D), np.int32)
    nd_fill = np.zeros((S2,), np.int32)
    if D > 0:
        for sid, vals, ts, its, reason, tn in letters:
            s = int(plan.sid_to_shard[min(max(sid, 0), N - 1)])
            k = int(nd_fill[s])
            if k < D:
                nd_sid[s, k], nd_vals[s, k], nd_ts[s, k] = sid, vals, ts
                nd_its[s, k] = its
                nd_reason[s, k], nd_tenant[s, k] = reason, tn
                nd_fill[s] = k + 1

    def place0(v):           # totals ride on shard 0; readback sums shards
        out = np.zeros((S2,) + v.shape, v.dtype)
        out[0] = v
        return out

    out = {f"tables/{f}": np.asarray(getattr(sh_tab, f))
           for f in DeviceTables._fields}
    out.update({
        "state/values": rows["values"],
        "state/timestamps": rows["timestamps"],
        "state/q_sid": nq_sid, "state/q_vals": nq_vals,
        "state/q_ts": nq_ts, "state/q_its": nq_its, "state/q_seq": nq_seq,
        "state/q_valid": nq_valid,
        "state/seq": fill.astype(np.int32),
        "state/tenant_emitted": place0(t_emitted),
        "state/tokens": np.zeros((S2, T), np.int32),
        "state/tenant_queued": t_queued,
        "state/tenant_dropped_quota": place0(t_drop_quota),
        "state/tenant_dropped_overflow": place0(t_drop_over),
        "state/ret_vals": rows["ret_vals"], "state/ret_ts": rows["ret_ts"],
        "state/ret_its": rows["ret_its"],
        "state/ret_count": rows["ret_count"],
        "state/quarantined": rows["quarantined"],
        "state/fault_count": rows["fault_count"],
        "state/fault_epoch": rows["fault_epoch"],
        "state/fault_total": rows["fault_total"],
        # every shard counts rounds alike, so moved fault windows stay
        # anchored
        "state/round_idx": np.full((S2,), round_idx, np.int32),
        "state/dlq_sid": nd_sid, "state/dlq_vals": nd_vals,
        "state/dlq_ts": nd_ts, "state/dlq_its": nd_its,
        "state/dlq_reason": nd_reason,
        "state/dlq_tenant": nd_tenant, "state/dlq_fill": nd_fill,
    })
    for k in STAT_KEYS:
        out[f"state/stats/{k}"] = place0(totals[k].reshape(()))
    if n_shards == 1:
        out = {k: v[0] for k, v in out.items()}
    else:
        out["gmap/sid_to_shard"] = plan.sid_to_shard.copy()
        out["gmap/sid_to_local"] = plan.sid_to_local.copy()
        out["gmap/sid_to_flat"] = plan.sid_to_flat.copy()
        out["gmap/priority"] = tab["priority"].astype(np.int32)
        out.update(_plan_arrays(plan))
    for k in ("pending/sid", "pending/vals", "pending/ts", "pending/its"):
        out[k] = np.array(arrays[k])

    new_meta = dict(meta)
    new_meta["registry"] = dict(meta["registry"])
    new_meta["registry"]["cfg"] = dataclasses.asdict(new_cfg)
    new_meta["kind"] = "sharded" if n_shards > 1 else "single"
    return out, new_meta


def _plan_arrays(plan: ShardPlan) -> dict:
    """A plan's maps as the ``plan/*`` arrays of a sharded snapshot."""
    return {f"plan/{f}": getattr(plan, f).copy()
            for f in ("sid_to_shard", "sid_to_local", "sid_to_flat",
                      "local_to_sid")}


# --------------------------------------------------------------------------
# stacking: the shard axis <-> per-shard views
# --------------------------------------------------------------------------

def _unstack(tup, S: int) -> list:
    """Per-shard views of a NamedTuple of (S, ...) leaves (a ``stats``
    dict leaf is split key by key)."""
    def leaf(x, d):
        return {k: v[d] for k, v in x.items()} if isinstance(x, dict) \
            else x[d]
    return [type(tup)(*(leaf(x, d) for x in tup)) for d in range(S)]


def _stack(parts: list):
    """The inverse of :func:`_unstack`: per-shard NamedTuples stacked
    leaf by leaf on a new leading shard axis."""
    def leaf(xs):
        return {k: torch.stack([x[k] for x in xs]) for k in xs[0]} \
            if isinstance(xs[0], dict) else torch.stack(xs)
    return type(parts[0])(*(leaf(list(xs)) for xs in zip(*parts)))


# --------------------------------------------------------------------------
# the sharded round
# --------------------------------------------------------------------------

def make_shard_round(cfg: EngineConfig, n_shards: int, n_local: int,
                     fanout_fn: Callable = fanout_reference,
                     fused: Optional[bool] = None,
                     use_kernel: Optional[bool] = None):
    """The sharded round body shared by the sharded step and superstep:
    ``round(tables, gmap, states, ingests) -> (states, sinks)`` where
    ``tables`` are the stacked (S, n_local, ...) tables, ``states`` and
    ``ingests`` lists of per-shard views, ``sinks`` one per shard.

    Exchange: stage 1 yields ``cfg.work`` items per shard, each bound for
    the shard owning its target; they are compacted into ``(S, E)``
    buckets (``E = cfg.exchange`` rows per destination, array order) and
    exchanged.  Items beyond a destination's rows are counted in the
    *sending* shard's ``dropped_overflow``, charged to the emitting
    stream's tenant and dead-lettered; ``exchange_slots=0`` sizes the
    buckets so overflow is impossible.

    Stage 1 is ``fanout_fn`` (signature of
    :func:`~repro_torch.core.engine.fanout_reference`) once per shard on
    both paths, against the shard's out-table and the global by-sid
    timestamps.  The compaction is one ``exchange_compact`` for all
    senders on both paths.  ``fused`` (default ``cfg.fused_round``,
    packed scheduler only) runs the post-exchange fetch+VM+window gate as
    one ``apply_programs`` for all shards; otherwise
    ``process_work_items``, shard by shard.  Bit-identical for fusable programs (the engine
    checks)."""
    S, L = n_shards, n_local
    N, C, F, T = cfg.n_streams, cfg.channels, cfg.max_out, cfg.n_tenants
    B, W, E = cfg.batch, cfg.work, cfg.exchange
    WR = S * E                            # work width after the exchange
    if fused is None:
        fused = cfg.fused_round
    fused = fused and cfg.scheduler == "packed"
    layout = rf_ref.RegLayout.from_cfg(cfg)

    def shard_round(tables: DeviceTables, gmap: GlobalMaps,
                    states: List[EngineState], ingests: List[IngestBatch]
                    ) -> Tuple[List[EngineState], List[SinkBatch]]:
        tabs = _unstack(tables, S)
        loc_of_sid = torch.clamp(gmap.sid_to_local, 0, L - 1).long()
        # tenant of every *global* sid as shard d sees it (queues and the
        # exchange carry global sids; a shard only resolves sids it owns)
        tenant_by_sid = [tab.tenant[loc_of_sid] for tab in tabs]
        states, statss, events = list(states), [None] * S, [None] * S

        # ---- phase 0 and the pop, every shard ---------------------------
        for d in range(S):
            tab, state, ing, t_of = tabs[d], states[d], ingests[d], \
                tenant_by_sid[d]
            stats = dict(state.stats)
            g_sid = torch.clamp(ing.sid, 0, N - 1)
            l_sid = loc_of_sid[g_sid.long()]
            state, stats = ingest_phase(
                state, stats, ing, l_sid, g_sid, tab.active[l_sid], L,
                tab.tenant[l_sid], tab.quota, tab.burst, fast_free=fused,
                quarantined=state.quarantined[l_sid])
            state, (e_sid, e_vals, e_ts, e_its, e_pop) = _pop(
                state, gmap.priority, B, t_of, tab.weight, cfg.scheduler,
                use_kernel=use_kernel)
            _inc(stats, "popped", _count(e_pop))
            e_g = torch.clamp(e_sid, 0, N - 1).long()
            e_loc = loc_of_sid[e_g]
            # events whose stream was revoked (or quarantined) while queued
            e_act = tab.active[e_loc]
            e_quar = state.quarantined[e_loc]
            e_poison = e_pop & e_act & e_quar
            e_valid = e_pop & e_act & ~e_quar
            _inc(stats, "dropped_revoked", _count(e_pop & ~e_act))
            state = dlq_append(state, e_sid, e_vals, e_ts, t_of[e_g],
                               DLQ_REVOKED, e_pop & ~e_act, its=e_its)
            _inc(stats, "dropped_poisoned", _count(e_poison))
            state = dlq_append(state, e_sid, e_vals, e_ts, t_of[e_g],
                               DLQ_POISONED, e_poison, its=e_its)
            states[d], statss[d] = state, stats
            events[d] = (e_sid, e_vals, e_ts, e_its, e_loc, e_valid)

        # ---- post-ingest snapshot: the global by-sid view ----------------
        values_by_sid, ts_by_sid = by_sid_snapshot(
            [s.values for s in states], [s.timestamps for s in states],
            gmap.sid_to_flat, use_kernel=use_kernel)

        # ---- stage 1: fan-out via the shard-local out-tables -------------
        items = []
        for d in range(S):
            e_sid, e_vals, e_ts, e_its, e_loc, e_valid = events[d]
            targets, _ = fanout_fn(e_loc, e_ts, e_valid, tabs[d].out_table,
                                   ts_by_sid, with_early=False)
            wi_t = targets.reshape(W)
            wi_valid = (wi_t >= 0) & torch.repeat_interleave(e_valid, F)
            t_safe = torch.clamp(wi_t, 0, N - 1).long()
            dest = torch.where(wi_valid, gmap.sid_to_shard[t_safe], S)
            items.append((wi_t, torch.repeat_interleave(e_sid, F),
                          torch.repeat_interleave(e_ts, F),
                          torch.repeat_interleave(e_its, F),
                          torch.repeat_interleave(e_vals, F, dim=0), dest))

        # ---- exchange compaction: route items to the target's owner ------
        xi, xf, x_drop = exchange_compact(
            *(torch.stack(p) for p in zip(*items)), S, E,
            use_kernel=use_kernel)
        for d in range(S):
            wi_t, wi_src, wi_ts, wi_its, wi_vals, _ = items[d]
            state, stats, drop = states[d], statss[d], x_drop[d]
            _inc(stats, "dropped_overflow", _count(drop))
            # exchange-slot contention is charged to the emitting stream's
            # owner (wi_src is always owned by the sending shard)
            src_ten = tenant_by_sid[d][torch.clamp(wi_src, 0, N - 1).long()]
            state = state._replace(tenant_dropped_overflow=_add_drop(
                state.tenant_dropped_overflow,
                torch.where(drop, src_ten, T), 1))
            states[d] = dlq_append(state, wi_src, wi_vals, wi_ts, src_ten,
                                   DLQ_OVERFLOW, drop, its=wi_its)

        # ---- the exchange: bucket (s -> d) lands on d from sender s ------
        ri = xi.transpose(0, 1).reshape(S, WR, 4)
        r_vals = xf.transpose(0, 1).reshape(S, WR, C)
        r_t, r_src, r_ts, r_its = ri.unbind(-1)
        r_valid = r_t >= 0
        rt_safe = torch.clamp(r_t, 0, N - 1)
        r_loc = loc_of_sid[rt_safe.long()]

        # ---- stages 2 + 3 -------------------------------------------------
        # quarantined rows are masked out of the effective active plane
        eff_active = tables.active & ~torch.stack(
            [s.quarantined for s in states])
        if fused:
            applied = apply_programs(
                layout, tables.in_table, tables.progs, tables.consts,
                tables.is_composite, eff_active, r_loc, rt_safe, r_src,
                r_vals, r_ts, r_valid, values_by_sid, ts_by_sid,
                use_kernel=use_kernel)

        # ---- stage 4, the fault plane: every shard -------------------------
        sinks = []
        for d in range(S):
            tab, state, stats = tabs[d], states[d], statss[d]
            if fused:
                new_vals, ts_out, live, keep, keep_ts, passf, badf = (
                    x[d] for x in applied)
                _inc(stats, "processed", _count(live))
                _inc(stats, "discarded_stale", _count(live & ~keep_ts))
                _inc(stats, "filtered", _count(live & keep_ts & ~passf))
                _inc(stats, "nonfinite", _count(badf & r_valid[d]))
            else:
                new_vals, ts_out, live, keep, counts, badf = \
                    process_work_items(
                        cfg, tab._replace(active=eff_active[d]), r_loc[d],
                        rt_safe[d], r_src[d], r_vals[d], r_ts[d],
                        r_valid[d], values_by_sid, ts_by_sid)
                for k, v in counts.items():
                    _inc(stats, k, v)
            state, stats, sink = store_and_emit(
                cfg, tab, state, stats, r_loc[d], r_t[d], r_src[d],
                new_vals, ts_out, keep, L, fast_free=fused, wi_its=r_its[d])
            # amplification is detected at the dispatch site (the source
            # shard owns the popped sid), non-finite results on the shard
            # owning the target row: each fault lands on its row's owner
            wi_t = items[d][0]
            e_loc, e_valid = events[d][4], events[d][5]
            fan = (wi_t.reshape(B, F) >= 0).sum(dim=1, dtype=I32)
            fault_evt = fault_events(tab.breaker, badf, r_valid[d],
                                     r_loc[d], fan, e_valid, e_loc, L)
            q_row = loc_of_sid[torch.clamp(state.q_sid, 0, N - 1).long()]
            state, stats = fault_phase(state, stats, tab.breaker, fault_evt,
                                       tab.active, tab.tenant, q_row)
            states[d] = state._replace(
                stats=stats, tenant_queued=tenant_occupancy(
                    state, tenant_by_sid[d], T))
            sinks.append(sink)
        return states, sinks

    return shard_round


def make_sharded_step(cfg: EngineConfig, n_shards: int, n_local: int,
                      fanout_fn: Callable = fanout_reference,
                      fused: Optional[bool] = None,
                      use_kernel: Optional[bool] = None):
    """The sharded round ``step(tables, gmap, state, ingest) -> (state,
    sink)``: every tables/state/ingest/sink leaf carries a leading
    ``(n_shards,)`` axis, ``gmap`` is shared.  Body and exchange semantics:
    :func:`make_shard_round`."""
    shard_round = make_shard_round(cfg, n_shards, n_local, fanout_fn,
                                   fused, use_kernel)

    def step(tables: DeviceTables, gmap: GlobalMaps, state: EngineState,
             ingest: IngestBatch) -> Tuple[EngineState, SinkBatch]:
        states, sinks = shard_round(tables, gmap, _unstack(state, n_shards),
                                    _unstack(ingest, n_shards))
        return _stack(states), _stack(sinks)

    return step


def make_sharded_superstep(cfg: EngineConfig, n_shards: int, n_local: int,
                           K: int, fanout_fn: Callable = fanout_reference,
                           fused: Optional[bool] = None,
                           use_kernel: Optional[bool] = None):
    """K sharded rounds as one call: ``superstep(tables, gmap, state, ring)
    -> (state, spool, ring)`` with per-shard leading axes on everything but
    ``gmap``; ``ring`` holds each shard's pre-routed (K, B) ingest grid.
    The loop of the JAX package's ``scan_rounds`` with the per-round spool
    bookkeeping (:func:`~repro_torch.core.engine.spool_round`) done shard
    by shard; the exchange runs inside every round.  Nothing inside reads
    a value back to the host."""
    assert K >= 1
    S, L = n_shards, n_local
    shard_round = make_shard_round(cfg, S, L, fanout_fn, fused, use_kernel)
    B, C, P = cfg.batch, cfg.channels, cfg.spool_slots(K)

    def superstep(tables: DeviceTables, gmap: GlobalMaps, state: EngineState,
                  ring: IngestRing
                  ) -> Tuple[EngineState, SinkSpool, IngestRing]:
        states = _unstack(state, S)
        grids = [ring_grid(r, K, B, C) for r in _unstack(ring, S)]
        spools = [_init_spool(P, C, ring.sid.device) for _ in range(S)]
        loc_of_sid = torch.clamp(gmap.sid_to_local, 0, L - 1).long()
        tenant_by_sid = [tables.tenant[d][loc_of_sid] for d in range(S)]
        for k in range(K):
            states, sinks = shard_round(
                tables, gmap, states,
                [IngestBatch(*(g[k] for g in grid)) for grid in grids])
            for d in range(S):
                states[d], spools[d] = spool_round(
                    states[d], spools[d], sinks[d], k, tenant_by_sid[d])
        return (_stack(states), _stack(spools),
                ring._replace(valid=ring.valid & (ring.rnd >= K)))

    return superstep


# --------------------------------------------------------------------------
# host-side wrapper
# --------------------------------------------------------------------------

class ShardedStreamEngine(StreamEngine):
    """:class:`~repro_torch.core.engine.StreamEngine` with the pub/sub
    plane sharded ``cfg.n_shards`` ways, the shards emulated on one device
    (CUDA by default, ``device="cpu"`` for the plain torch path).  Same
    public API (post/round/drain/superstep/value_of/ts_of/counters and the
    live admission methods); admissions also route the new sid to a shard,
    and :meth:`rebalance` fights occupancy skew."""

    # ------------------------------------------------------------- layout
    def _init_layout(self, priority: Optional[np.ndarray]) -> None:
        host_tables, self.plan = self.registry.build_sharded_tables(priority)
        self.tables = DeviceTables.from_host(host_tables, self.device)
        self.gmap = GlobalMaps.build(priority, self.plan, self.device)
        self.state = sharded_init_state(self.cfg, self.plan, self.device)
        self._bind_fns()
        self._ring_dirty = False   # placement changed: re-stage everything
        self._init_slots()

    def _layout_key(self):
        """Cache key of the round closures: what they are shaped by (the
        shard and row counts; plan *content* is data in ``gmap``)."""
        return ("sharded", self.plan.n_shards, self.plan.n_local)

    def _make_step(self, fused: bool):
        return make_sharded_step(self.cfg, self.plan.n_shards,
                                 self.plan.n_local, self._fanout_fn, fused,
                                 self.use_kernel)

    def _make_superstep(self, K: int, fused: bool):
        return make_sharded_superstep(self.cfg, self.plan.n_shards,
                                      self.plan.n_local, K, self._fanout_fn,
                                      fused, self.use_kernel)

    def _init_slots(self) -> None:
        """(Re)build the per-shard slot bookkeeping from the registry:
        ``_occupancy[s]`` live streams on shard ``s``, ``_spare[s]`` the
        sorted inactive sids placed there (swap partners for incoming
        placements), ``_holes[s]`` the rows no sid maps to (the cheapest
        landing slots)."""
        S = self.plan.n_shards
        self._occupancy = np.zeros((S,), np.int64)
        self._spare: List[List[int]] = [[] for _ in range(S)]
        self._holes: List[List[int]] = [
            sorted(np.nonzero(self.plan.local_to_sid[s] < 0)[0].tolist())
            for s in range(S)]
        streams = self.registry.streams
        for sid in range(self.cfg.n_streams):
            shard = int(self.plan.sid_to_shard[sid])
            if sid < len(streams) and streams[sid] is not None:
                self._occupancy[shard] += 1
            else:
                self._spare[shard].append(sid)

    def _by_sid(self, x: torch.Tensor) -> np.ndarray:
        S, L = self.plan.n_shards, self.plan.n_local
        return x.cpu().numpy().reshape((S * L,) + tuple(x.shape[2:]))[
            self.plan.sid_to_flat]

    # -------------------------------------------------------------- ingest
    def _take_ingest(self) -> IngestBatch:
        """Admit at most one pending SU per stream (like the single-device
        engine), then route each SU to its owner shard in batch order:
        (S, B) planes."""
        sid, vals, ts, valid, its = self._take_host()
        B, C, S = self.cfg.batch, self.cfg.channels, self.plan.n_shards
        # route on the same clipped sid the per-shard round stores to
        sid = np.clip(sid, 0, self.cfg.n_streams - 1)
        r_sid = np.zeros((S, B), np.int32)
        r_vals = np.zeros((S, B, C), np.float32)
        r_ts = np.zeros((S, B), np.int32)
        r_valid = np.zeros((S, B), bool)
        r_its = np.zeros((S, B), np.int32)
        fill = np.zeros((S,), np.int64)
        for i in np.nonzero(valid)[0]:
            s = int(self.plan.sid_to_shard[sid[i]])
            j = fill[s]
            r_sid[s, j], r_vals[s, j], r_ts[s, j] = sid[i], vals[i], ts[i]
            r_its[s, j] = its[i]
            r_valid[s, j] = True
            fill[s] += 1
        return IngestBatch(*(_tensor(a, self.device)
                             for a in (r_sid, r_vals, r_ts, r_valid, r_its)))

    # --------------------------------------------------------------- rounds
    def round(self) -> SinkBatch:
        """One sharded round; the sink is the shard-concatenated
        ``(n_shards * sink_buffer,)`` layout."""
        self._last_base = self._rounds_done
        self.state, sink = self._step(self._run_tables, self.gmap,
                                      self.state, self._take_ingest())
        self._rounds_done += 1
        self._maybe_checkpoint()
        return SinkBatch(*(x.reshape((-1,) + tuple(x.shape[2:]))
                           for x in sink))

    # ----------------------------------------------------------- supersteps
    def _release_ring_slot(self, slot) -> None:
        s, j = slot
        self._ring_free[s].append(j)

    def _stage(self, K: int) -> None:
        """Superstep boundary: assign rounds exactly like K sequential
        ``_take_ingest`` calls and route every staged SU to its owner
        shard's ring slice.  The per-shard ring is kept across boundaries:
        carried SUs keep their resident payloads and only the routing tags
        travel again (two host->device copies: the int32 planes and the
        new payloads).  A placement change (admission routing,
        ``rebalance``, ``rewire``) sets ``_ring_dirty``, which voids the
        ring, so a moved sid never consumes a stale shard's slot."""
        S, R, C = self.plan.n_shards, self.cfg.ring_slots(K), self.cfg.channels
        N = self.cfg.n_streams
        if self._ring is None or self._ring_K != K or self._ring_dirty:
            def z(shape, dtype=I32):
                return torch.zeros(shape, dtype=dtype, device=self.device)
            self._ring = IngestRing(
                sid=z((S, R)), vals=z((S, R, C), F32), ts=z((S, R)),
                its=z((S, R)),
                rnd=torch.full((S, R), K, dtype=I32, device=self.device),
                pos=z((S, R)), valid=z((S, R), BOOL))
            self._ring_K = K
            self._ring_free = [list(range(R)) for _ in range(S)]
            for e in self._pending:     # slots of the old ring are void
                e[3] = None
            self._ring_dirty = False

        def shard_of(e):
            return int(self.plan.sid_to_shard[min(max(int(e[0]), 0), N - 1)])

        assigned = self._assign_rounds(K)
        carried = [e for e in self._pending if e[3] is not None]
        writes = []
        for e, _k, _i in assigned:
            s = shard_of(e)
            if e[3] is not None and e[3][0] != s:   # placement moved: free
                self._ring_free[e[3][0]].append(e[3][1])   # the stale
                e[3] = None                         # shard's slot, re-ship
            if e[3] is None:
                if self._ring_free[s]:
                    e[3] = (s, self._ring_free[s].pop())
                else:           # youngest carried SU on s spills its slot
                    victim = next(x for x in reversed(carried)
                                  if x[3] is not None and x[3][0] == s)
                    e[3], victim[3] = victim[3], None
                writes.append(e)
        for e in self._pending:     # pre-ship: earliest carried SUs claim
            if e[3] is None:        # leftover slots, cutting future ships
                s = shard_of(e)
                if self._ring_free[s]:
                    e[3] = (s, self._ring_free[s].pop())
                    writes.append(e)
        # int32 planes: w_slot, w_sid, w_ts, w_its, rnd, pos, valid
        ints = np.zeros((7, S, R), np.int32)
        ints[0] = R
        ints[4] = K
        w_vals = np.zeros((S, R, C), np.float32)
        wn = np.zeros((S,), np.int64)
        for e in writes:
            s, j = e[3]
            q = int(wn[s])
            wn[s] += 1
            ints[0:4, s, q] = j, min(max(int(e[0]), 0), N - 1), e[2], e[4]
            w_vals[s, q] = e[1]
        col: dict = {}                        # (shard, round) -> next column
        for e, k, _i in assigned:             # (round, take-order) order
            s, j = e[3]
            c = col.get((s, k), 0)
            col[(s, k)] = c + 1
            ints[4:7, s, j] = k, c, 1
        for e in self._pending:
            if e[3] is not None:
                s, j = e[3]
                ints[6, s, j] = 1             # carried overflow stays resident
        w_slot, w_sid, w_ts, w_its, rnd, pos, valid = \
            _tensor(ints, self.device)
        self._ring = _stage_ring_op(self._ring, w_slot, w_sid,
                                    _tensor(w_vals, self.device), w_ts,
                                    w_its, rnd, pos, valid.bool())
        for e, _k, _i in assigned:            # consumed by this superstep:
            s, j = e[3]                       # slots reusable next boundary
            self._ring_free[s].append(j)

    def _run_superstep(self, K: int) -> SinkSpool:
        self.state, spool, self._ring = self._superstep_fn(K)(
            self._run_tables, self.gmap, self.state, self._ring)
        return spool

    def spool_sinks(self, spool: SinkSpool, K=None) -> List[SinkBatch]:
        """Per-round SinkBatches (host arrays) from the per-shard spools:
        each round's batch is the shard-concatenated layout ``round()``
        returns.  One readback of the spool."""
        S, C = self.cfg.sink_buffer, self.cfg.channels
        n_sh = self.plan.n_shards
        sid, vals, ts, its, rnd, fill = (getattr(spool, f).cpu().numpy()
                                         for f in ("sid", "vals", "ts", "its",
                                                   "rnd", "fill"))
        K = K or self._ring_K or 1
        sinks = []
        for k in range(K):
            b_sid = np.zeros((n_sh * S,), np.int32)
            b_vals = np.zeros((n_sh * S, C), np.float32)
            b_ts = np.zeros((n_sh * S,), np.int32)
            b_valid = np.zeros((n_sh * S,), bool)
            b_its = np.zeros((n_sh * S,), np.int32)
            for s in range(n_sh):
                idx = np.nonzero(rnd[s, :fill[s]] == k)[0]
                n = len(idx)
                b_sid[s * S:s * S + n] = sid[s, idx]
                b_vals[s * S:s * S + n] = vals[s, idx]
                b_ts[s * S:s * S + n] = ts[s, idx]
                b_its[s * S:s * S + n] = its[s, idx]
                b_valid[s * S:s * S + n] = True
            sinks.append(SinkBatch(b_sid, b_vals, b_ts, b_valid, b_its))
        return sinks

    # ------------------------------------------------- dynamic admission
    def _table_row(self, sid: int) -> Tuple[int, int]:
        return (int(self.plan.sid_to_shard[sid]),
                int(self.plan.sid_to_local[sid]))

    def _swap_placement(self, a: int, b: int) -> None:
        """Exchange the physical slots of two sids in the host plan (both
        inert on the device: inactive rows, or drained active rows that
        :func:`~repro_torch.core.admission.migrate_row` just moved)."""
        p = self.plan
        for arr in (p.sid_to_shard, p.sid_to_local, p.sid_to_flat):
            arr[a], arr[b] = int(arr[b]), int(arr[a])
        p.local_to_sid[p.sid_to_shard[a], p.sid_to_local[a]] = a
        p.local_to_sid[p.sid_to_shard[b], p.sid_to_local[b]] = b

    def _set_gmap(self, sid: int, priority: int) -> None:
        _place_sid_op(self.gmap, sid, int(self.plan.sid_to_shard[sid]),
                      int(self.plan.sid_to_local[sid]), self.plan.n_local,
                      priority)

    def _claim_slot(self, sid: int, want: int) -> Optional[int]:
        """Claim a physical slot on shard ``want`` for ``sid``: an unmapped
        hole when one exists, otherwise a swap with a spare (inactive) sid
        placed there.  Edits the host plan only; the caller migrates the
        device rows when ``sid`` is active.  Returns the swap partner, or
        ``None`` for a hole."""
        p = self.plan
        cur, cur_l = int(p.sid_to_shard[sid]), int(p.sid_to_local[sid])
        if self._holes[want]:
            loc = self._holes[want].pop(0)
            p.sid_to_shard[sid], p.sid_to_local[sid] = want, loc
            p.sid_to_flat[sid] = want * p.n_local + loc
            p.local_to_sid[want, loc] = sid
            p.local_to_sid[cur, cur_l] = -1
            bisect.insort(self._holes[cur], cur_l)
            return None
        partner = self._spare[want].pop(0)
        self._swap_placement(sid, partner)
        bisect.insort(self._spare[cur], partner)
        return partner

    def _free_slots(self, shard: int) -> int:
        return len(self._holes[shard]) + len(self._spare[shard])

    def _place_sid(self, sid: int, tid: int, priority: int) -> None:
        """Route a newly admitted sid to a shard: the ``"tenant"``
        partition keeps a tenant's pipeline together (tid hash), the
        ``"block"`` partition takes the least-loaded shard.  When that is
        not the sid's planned shard, the sid claims a hole or swaps with a
        spare sid there — every row involved is inert, so placement is
        host bookkeeping plus a lookup-map edit."""
        S = self.plan.n_shards
        cur = int(self.plan.sid_to_shard[sid])
        self._spare[cur].remove(sid)
        if self.cfg.partition == "tenant":
            want = tid % S
        else:
            cand = [s for s in range(S) if s == cur or self._free_slots(s)]
            want = min(cand, key=lambda s: (self._occupancy[s], s))
        if want != cur and self._free_slots(want):
            partner = self._claim_slot(sid, want)
            if partner is not None:
                self._set_gmap(partner, 0)
            cur = want
            self._ring_dirty = True     # sid routing moved: void the ring
        self._occupancy[cur] += 1
        self._set_gmap(sid, priority)

    def _released_sid(self, sid: int) -> None:
        shard = int(self.plan.sid_to_shard[sid])
        self._occupancy[shard] -= 1
        bisect.insort(self._spare[shard], sid)

    def rebalance(self, tolerance: int = 1) -> int:
        """Migrate streams from overfull to underfull shards until the
        per-shard occupancy spread is at most ``tolerance``; returns the
        number of moves.  Each move is one in-place
        :func:`~repro_torch.core.admission.migrate_row` (the state slice
        travels with the row) plus a lookup-map edit.  Queues must be
        drained: in-flight SUs reference the old placement."""
        if bool(self.state.q_valid.any()) or self._pending:
            raise ValueError(
                "rebalance() while SUs are in flight; drain() first")
        moved = 0
        prio = self.gmap.priority.cpu().numpy()
        while True:
            hi = int(np.argmax(self._occupancy))
            lo = int(np.argmin(self._occupancy))
            if self._occupancy[hi] - self._occupancy[lo] <= tolerance \
                    or not self._free_slots(lo):
                break
            # deterministic pick: the highest active sid on the full shard
            sid = max(s for s in range(self.cfg.n_streams)
                      if int(self.plan.sid_to_shard[s]) == hi
                      and s < len(self.registry.streams)
                      and self.registry.streams[s] is not None)
            src_row = self._table_row(sid)
            partner = self._claim_slot(sid, lo)
            admission.migrate_row(self.tables, self.state, src_row,
                                  self._table_row(sid))
            self._occupancy[hi] -= 1
            self._occupancy[lo] += 1
            if partner is not None:
                self._set_gmap(partner, 0)
            self._set_gmap(sid, int(prio[sid]))
            moved += 1
        if moved:
            self._ring_dirty = True
            self._refresh_fusable()     # program rows moved with their rows
        return moved

    def rewire(self) -> None:
        """Re-lower after ``Registry.subscribe``/new streams.  With the
        ``"tenant"`` partition new streams can move sid placement; the
        per-sid state is then permuted into the new layout (queues must be
        empty — in-flight SUs cannot change shards).  Tensors keep their
        storage while the layout's shapes do."""
        prio = self.gmap.priority.cpu().numpy()
        host_tables, new_plan = self.registry.build_sharded_tables(prio)
        old = self.plan
        same_shape = new_plan.n_local == old.n_local
        moved = not same_shape or bool(
            (new_plan.sid_to_flat != old.sid_to_flat).any())
        if moved:
            if bool(self.state.q_valid.any()) or self._pending:
                raise ValueError(
                    "rewire() changed stream placement while SUs are in "
                    "flight; drain() before rewiring")
            S, L = new_plan.n_shards, new_plan.n_local
            permuted = {}
            for f in ("values", "timestamps", "ret_vals", "ret_ts",
                      "ret_its", "ret_count", "quarantined", "fault_count",
                      "fault_epoch", "fault_total"):
                x = getattr(self.state, f)
                fill = INT_MIN if f == "timestamps" else 0
                out = np.full((S * L,) + tuple(x.shape[2:]), fill,
                              x.cpu().numpy().dtype)
                out[new_plan.sid_to_flat] = self._by_sid(x)
                permuted[f] = out.reshape((S, L) + tuple(x.shape[2:]))
            self.state = self.state._replace(**{
                f: _assign(getattr(self.state, f), a)
                for f, a in permuted.items()})
        self.plan = new_plan
        # the QoS tables survive a re-lower (the registry does not mirror
        # them); the breaker knobs come back from the config
        self.tables = DeviceTables(*(
            getattr(self.tables, f) if f in ("weight", "quota", "burst")
            else _assign(getattr(self.tables, f), getattr(host_tables, f))
            for f in DeviceTables._fields))
        fresh = GlobalMaps.build(prio, new_plan, "cpu")
        self.gmap = GlobalMaps(*(_assign(a, b.numpy())
                                 for a, b in zip(self.gmap, fresh)))
        if not same_shape:       # the round closures are shaped by n_local
            self._bind_fns()
        self._refresh_fusable()
        self._ring_dirty = True         # plan rebuilt: void the ring cache
        self._init_slots()

    # ------------------------------------------------------------- readback
    def value_of(self, stream) -> np.ndarray:
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        return self.state.values[self._table_row(sid)].cpu().numpy()

    def ts_of(self, stream) -> int:
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        return int(self.state.timestamps[self._table_row(sid)])

    # ------------------------------------------------- durability plane
    def snapshot(self):
        """The single-device snapshot's arrays (state leaves with their
        leading shard axis) plus the lookup maps (``gmap/*``) and the
        placement plan (``plan/*``), under ``kind="sharded"``."""
        arrays, meta = StreamEngine.snapshot(self)
        for f in GlobalMaps._fields:
            arrays[f"gmap/{f}"] = _host_copy(getattr(self.gmap, f))
        arrays.update(_plan_arrays(self.plan))
        meta["kind"] = "sharded"
        return arrays, meta

    def _install_snapshot(self, arrays, meta) -> None:
        """Restore half of :meth:`snapshot`: the placement plan first (the
        round closures are shaped by it: a new layout gets or reuses its
        own), then the lookup maps, tables, state and backlog, then the
        slot books from the restored registry.  The snapshot's shard count
        must be the config's: ``reshard_snapshot`` it first otherwise."""
        local_to_sid = np.array(arrays["plan/local_to_sid"], np.int32)
        n_shards = int(local_to_sid.shape[0])
        if n_shards != self.cfg.n_shards:
            raise ValueError(
                f"snapshot carries {n_shards} shards but cfg.n_shards="
                f"{self.cfg.n_shards}; reshard_snapshot() it first (or "
                f"restore_engine(..., n_shards=...))")
        self.plan = ShardPlan(
            n_shards=n_shards, n_local=int(local_to_sid.shape[1]),
            sid_to_shard=np.array(arrays["plan/sid_to_shard"], np.int32),
            sid_to_local=np.array(arrays["plan/sid_to_local"], np.int32),
            sid_to_flat=np.array(arrays["plan/sid_to_flat"], np.int32),
            local_to_sid=local_to_sid)
        self.gmap = GlobalMaps(*(_tensor(arrays[f"gmap/{f}"], self.device)
                                 for f in GlobalMaps._fields))
        StreamEngine._install_snapshot(self, arrays, meta)
        self._ring_dirty = True
        self._init_slots()

    def _owner_edits(self, sid, valid):
        """``(shard, mask)`` per shard owning a valid item, ascending."""
        owner = self.plan.sid_to_shard[np.clip(sid, 0, self.cfg.n_streams - 1)]
        return [(s, valid & (owner == s))
                for s in sorted(set(owner[valid].tolist()))]

    def _apply_requeue(self, sid, vals, ts, valid, tenant, its) -> None:
        """Route each padded requeue item to its owner shard: one
        :func:`~repro_torch.core.admission.requeue_shard` edit per shard
        touched."""
        dev = self.device
        args = [_tensor(a, dev) for a in (sid, vals, ts)]
        for s, mask in self._owner_edits(sid, valid):
            admission.requeue_shard(self.state, s, *args, _tensor(mask, dev),
                                    _tensor(tenant, dev), _tensor(its, dev))
        self._sync_admitted()

    def _apply_respool(self, sid, vals, ts, reason, tenant, its,
                       valid) -> None:
        """Route each refused dead letter back to its owner shard's spool:
        one :func:`~repro_torch.core.admission.respool_shard` edit per
        shard touched."""
        dev = self.device
        args = [_tensor(a, dev) for a in (sid, vals, ts, reason, tenant, its)]
        for s, mask in self._owner_edits(sid, valid):
            admission.respool_shard(self.state, s, *args, _tensor(mask, dev))
        self._sync_admitted()


def _assign(dst: torch.Tensor, src) -> torch.Tensor:
    """``src`` (host array) written into ``dst`` in place when the shapes
    agree; otherwise a new tensor on ``dst``'s device."""
    t = _tensor(src, "cpu")
    if tuple(t.shape) == tuple(dst.shape):
        return dst.copy_(t)
    return t.to(dst.device)
