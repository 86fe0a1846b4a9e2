"""Plain torch references for the fused round: the CPU path and the
bit-exactness oracle of :mod:`repro_torch.kernels.round_fuse.kernel` —
the port of the JAX package's ``round_fuse/ref.py``.

``pop_dispatch_ref`` is ``sched_pop`` + the engine's stage-1 expansion,
``apply_programs_ref`` is ``engine.process_work_items`` with the
reduced-branch VM (the transcendental opcodes run as NOP), and
``exchange_compact_ref`` is the sharded round's ranked-scatter
compaction.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import consistency, program as pvm
from repro_torch.kernels.sched_pop.ref import sched_pop_ref

INT_MIN = torch.iinfo(torch.int32).min + 1
INT_MAX = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------------
# free-slot search
# --------------------------------------------------------------------------

def first_free_slots(q_valid: torch.Tensor, X: int) -> torch.Tensor:
    """Indices of the first ``X`` free queue slots, ascending, padded with
    ``Q`` (int32).  The running count of free slots is non-decreasing in
    steps of one, so the k-th free slot is the first index where the count
    reaches ``k``: one cumsum plus a ``searchsorted``."""
    free_count = torch.cumsum((~q_valid).to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, X + 1, dtype=torch.int32, device=q_valid.device)
    return torch.searchsorted(free_count, want, side="left").to(torch.int32)


# --------------------------------------------------------------------------
# fusable program classes
# --------------------------------------------------------------------------

# The fused round runs the VM without the transcendental opcodes; programs
# touching them take the staged path (its VM is plain torch).
NON_FUSABLE_OPS = frozenset({
    pvm.OP_EXP, pvm.OP_LOG, pvm.OP_SIN, pvm.OP_COS, pvm.OP_POW, pvm.OP_TANH,
})
FUSABLE_OPS = frozenset(range(pvm.N_OPS)) - NON_FUSABLE_OPS


def fusable_rows(progs) -> np.ndarray:
    """Host-side fusability bitmap over the leading dims of a ``progs``
    table (``(N, L, 4)`` int32): True where every instruction's opcode is
    in :data:`FUSABLE_OPS` and in range and no operand is negative — the
    JAX package's rule, kept so both packages pick the same path."""
    p = np.asarray(progs)
    ops = p[..., 0]
    bad = (ops < 0) | (ops >= pvm.N_OPS)
    for op in NON_FUSABLE_OPS:
        bad |= ops == op
    bad |= (p[..., 1:] < 0).any(axis=-1)
    return ~bad.any(axis=-1)


def fusable_program(prog) -> bool:
    """Fusability of one host ``(L, 4)`` bytecode table (True for ``None``:
    a vacated row is the all-NOP program)."""
    if prog is None:
        return True
    return bool(fusable_rows(np.asarray(prog)[None]).all())


class RegLayout(NamedTuple):
    """The VM register-file layout of one engine config, detached from
    :class:`~repro_torch.core.config.EngineConfig`."""
    max_in: int
    channels: int
    n_regs: int
    reg_inputs: int
    reg_prev: int
    reg_ts: int
    reg_trigger: int
    reg_result: int
    reg_pref: int
    reg_postf: int

    @classmethod
    def from_cfg(cls, cfg) -> "RegLayout":
        return cls(*(getattr(cfg, f) for f in cls._fields))


_FUSED_OPS = tuple(sorted(FUSABLE_OPS))


def execute_batch_fused(progs, consts, regs) -> torch.Tensor:
    """``pvm.execute_batch`` restricted to :data:`FUSABLE_OPS` —
    bit-identical to it for fusable programs, NOP on the transcendental
    opcodes."""
    return pvm.execute_batch(progs, consts, regs, ops=_FUSED_OPS)


# --------------------------------------------------------------------------
# stage 1: pop + dispatch
# --------------------------------------------------------------------------

def pop_dispatch_ref(prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts,
                     batch: int, out_table, active):
    """Packed top-``batch`` pop + revocation gate + subscriber fan-out.

    Per-slot planes as in ``sched_pop_ref``; ``out_table`` (N, F) /
    ``active`` (N,) are indexed by the popped sids (clipped).  Returns
    ``(take, (e_sid, e_vals, e_ts, e_pop, e_act), (wi_t, wi_src, wi_vals,
    wi_ts))`` — the winning slots, the popped events with their
    row-active mask, and the (W,)-flat work items with targets already
    -1 for invalid/revoked events."""
    take = sched_pop_ref(prio_slot, seq, valid, t_slot, w_slot, batch)
    t = take.long()
    e_sid, e_vals, e_ts, e_pop = sid[t], vals[t], ts[t], valid[t]
    N, F = out_table.shape
    e_row = torch.clamp(e_sid, 0, N - 1).long()
    e_act = active[e_row]
    e_valid = e_pop & e_act
    targets = out_table[e_row]                             # (B, F)
    tvalid = (targets >= 0) & e_valid[:, None]
    wi_t = torch.where(tvalid, targets, -1).reshape(batch * F)
    wi_src = torch.repeat_interleave(e_sid, F)
    wi_vals = torch.repeat_interleave(e_vals, F, dim=0)
    wi_ts = torch.repeat_interleave(e_ts, F)
    return take, (e_sid, e_vals, e_ts, e_pop, e_act), \
        (wi_t, wi_src, wi_vals, wi_ts)


# --------------------------------------------------------------------------
# stages 2 + 3: fetch + reduced VM + Listing-2 window gate
# --------------------------------------------------------------------------

def fetch_and_run(layout: RegLayout, in_table, progs, consts, rows, t_sid,
                  wi_src, wi_vals, wi_ts, values_by_sid, timestamps_by_sid,
                  ops=pvm.ALL_OPS):
    """Stage 2 (co-input fetch, the trigger slot overridden by the fresh
    SU) and the VM of stage 3 for (W,) work items; shared by the fused
    reference and the engine's staged ``process_work_items``.  ``rows``
    index the tables, ``t_sid`` the value/timestamp snapshot (both
    in-range).  Returns ``(regs_out, ts_in, in_valid, prev_ts)``."""
    W = t_sid.shape[0]
    M, C = layout.max_in, layout.channels
    n_sid = timestamps_by_sid.shape[0]
    rows, t_sid = rows.long(), t_sid.long()

    in_row = in_table[rows]                                # (W, M)
    in_valid = in_row >= 0
    src_safe = torch.clamp(in_row, 0, n_sid - 1).long()
    vals_in = values_by_sid[src_safe]                      # (W, M, C)
    ts_in = torch.where(in_valid, timestamps_by_sid[src_safe], INT_MIN)
    # first valid co-input equal to the source (argmax of bool: 0 if none)
    match = (in_row == wi_src[:, None]) & in_valid
    trig = torch.argmax(match.to(torch.int32), dim=1)
    widx = torch.arange(W, device=rows.device)
    vals_in[widx, trig] = wi_vals                          # fresh SU overrides
    ts_in[widx, trig] = wi_ts
    prev_vals = values_by_sid[t_sid]
    prev_ts = timestamps_by_sid[t_sid]

    regs = torch.zeros((W, layout.n_regs), dtype=torch.float32,
                       device=rows.device)
    flat_in = torch.where(in_valid[..., None], vals_in,
                          torch.zeros_like(vals_in)).reshape(W, M * C)
    regs[:, layout.reg_inputs:layout.reg_inputs + M * C] = flat_in
    regs[:, layout.reg_prev:layout.reg_prev + C] = prev_vals
    regs[:, layout.reg_ts] = wi_ts.to(torch.float32)
    regs[:, layout.reg_trigger] = trig.to(torch.float32)
    regs_out = pvm.execute_batch(progs[rows], consts[rows], regs, ops=ops)
    return regs_out, ts_in, in_valid, prev_ts


def verdict(layout: RegLayout, regs_out, wi_ts, prev_ts, ts_in, in_valid):
    """Stage 3's result and Listing-2 gate from the final register files:
    ``(new_vals, ts_out, keep_ts, passf, badf)`` — non-finite results
    zeroed (``badf`` flags them), ``passf`` = both filter registers
    nonzero (a subnormal reads as zero, as in the VM)."""
    C = layout.channels
    new_vals = regs_out[:, layout.reg_result:layout.reg_result + C]
    finite = torch.isfinite(new_vals)
    new_vals = torch.where(finite, new_vals, torch.zeros_like(new_vals))
    passf = (pvm.flush(regs_out[:, layout.reg_pref]) != 0.0) \
        & (pvm.flush(regs_out[:, layout.reg_postf]) != 0.0)
    keep_ts = consistency.keep_mask(wi_ts, prev_ts)
    ts_out = consistency.output_timestamp(wi_ts, prev_ts, ts_in, in_valid)
    return new_vals, ts_out, keep_ts, passf, (~finite).any(dim=-1)


def apply_programs_ref(
    layout: RegLayout,
    in_table, progs, consts, is_composite, active,  # per-row tables
    rows,                       # (W,) row into the tables (clipped, in-range)
    t_sid,                      # (W,) target id in values_by_sid's space
    wi_src, wi_vals, wi_ts, wi_valid,
    values_by_sid, timestamps_by_sid,
):
    """``engine.process_work_items`` with :func:`execute_batch_fused`,
    returning the raw masks instead of summed counts: ``(new_vals,
    ts_out, live, keep, keep_ts, passf, badf)`` where ``passf = pref &
    postf`` and ``badf`` flags non-finite VM results (pre-``wi_valid``)."""
    regs_out, ts_in, in_valid, prev_ts = fetch_and_run(
        layout, in_table, progs, consts, rows, t_sid, wi_src, wi_vals, wi_ts,
        values_by_sid, timestamps_by_sid, ops=_FUSED_OPS)
    new_vals, ts_out, keep_ts, passf, badf = verdict(
        layout, regs_out, wi_ts, prev_ts, ts_in, in_valid)
    r = rows.long()
    live = wi_valid & is_composite[r] & active[r]
    keep = live & keep_ts & passf
    return new_vals, ts_out, live, keep, keep_ts, passf, badf


# --------------------------------------------------------------------------
# sharded exchange compaction
# --------------------------------------------------------------------------

def exchange_compact_ref(wi_t, wi_src, wi_ts, wi_its, wi_vals, dest_shard,
                         n_shards: int, slots: int):
    """Rank-and-scatter (W,) work items of one sending shard into fixed
    per-destination exchange buckets: per destination, items keep array
    order; an item ranked ``>= slots`` overflows.  ``dest_shard == n_shards``
    marks unrouted lanes (they take no rank).  Returns ``(xi, xf,
    x_drop)``: (D, E, 4) int32 ``(t, src, ts, its)`` (-1 where empty),
    (D, E, C) float32 payloads (+0.0 where empty) and the (W,) overflow
    mask."""
    C = wi_vals.shape[1]
    dev = wi_t.device
    routed = dest_shard < n_shards
    d_safe = torch.clamp(dest_shard, 0, n_shards - 1).long()
    onehot = routed[:, None] & (
        d_safe[:, None] == torch.arange(n_shards, device=dev)[None, :])
    rank = (torch.cumsum(onehot.to(torch.int32), 0, dtype=torch.int32)
            - 1).gather(1, d_safe[:, None])[:, 0]
    fits = routed & (rank < slots)
    DE = n_shards * slots
    slot = torch.where(fits, d_safe * slots + rank, DE).long()
    payload = torch.stack([wi_t, wi_src, wi_ts, wi_its], dim=-1)   # (W, 4)
    xi = torch.full((DE + 1, 4), -1, dtype=torch.int32, device=dev)
    xi[slot] = payload.to(torch.int32)
    xf = torch.zeros((DE + 1, C), dtype=torch.float32, device=dev)
    xf[slot] = wi_vals
    return (xi[:DE].reshape(n_shards, slots, 4),
            xf[:DE].reshape(n_shards, slots, C), routed & ~fits)
